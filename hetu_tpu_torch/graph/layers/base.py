"""Layer base."""


class BaseLayer(object):
    def __call__(self, *args, **kwargs):
        raise NotImplementedError

    def make_name(self, default):
        return getattr(self, "name", None) or default


class Sequence(BaseLayer):
    def __init__(self, *layers):
        self.layers = layers

    def __call__(self, x):
        for layer in self.layers:
            x = layer(x)
        return x
