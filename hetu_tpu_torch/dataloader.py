"""Dataloader: prefetching batch feeder with DP sharding, the port of the
JAX package's ``dataloader.py`` (reference python/hetu/dataloader.py:
the ring of pinned CPU arrays :30-100, DP sharding ``set_dp_rank`` :102,
model-parallel slicing :110-141, ``DataloaderOp`` multiplexing named
loaders :186).

Batches are assembled host-side as numpy.  ``start_prefetch`` (wired by
the graph executor when ``config.prefetch`` is on) runs the host work
(fancy-index slicing, dtype coercion) and the ``transform`` on a
background thread feeding a bounded ring (depth 3, the reference's
queue_size).  The graph executor's transform is :func:`device_transform`:
on CUDA the batch goes into pinned host memory and is copied with
``non_blocking`` on a side stream, and ``get_arr`` makes the consumer's
stream wait on that copy's event before it hands the tensor out.  An
error of the producer or of its copy is raised by the next ``get_arr``;
the ring never falls back to a synchronous copy.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from . import locks
from .graph.node import Op


class _Staged:
    """A batch on its way to the card: the device tensor and the event
    recorded after its copy on the side stream."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor, event):
        self.tensor, self.event = tensor, event

    def ready(self):
        """The tensor, safe to read on the current stream."""
        cur = torch.cuda.current_stream(self.tensor.device)
        cur.wait_event(self.event)
        self.tensor.record_stream(cur)
        return self.tensor


def _ready(item):
    return item.ready() if isinstance(item, _Staged) else item


def coerce(arr):
    """A batch as the executors feed it: float64 as f32, int64 as int32."""
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        return arr.astype(np.float32)
    if arr.dtype == np.int64:
        return arr.astype(np.int32)
    return arr


def device_transform(device):
    """The ring's step that puts a batch on ``device``.  On a CUDA device
    the batch is coerced, pinned, and copied with ``non_blocking`` on a
    side stream; an event recorded after the copy orders the consumer
    behind it.  On the CPU it becomes a tensor there."""
    device = torch.device(device)
    if device.type == "cpu":
        return lambda arr: torch.from_numpy(np.ascontiguousarray(coerce(arr)))
    stream = torch.cuda.Stream(device)

    def transform(arr):
        host = torch.from_numpy(np.ascontiguousarray(coerce(arr)))
        host = host.pin_memory()
        with torch.cuda.stream(stream):
            t = host.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(t, event)

    return transform


class _PrefetchRing:
    """Bounded single-producer background prefetch."""

    def __init__(self, producer, depth=3, transform=None):
        self.producer = producer
        self.transform = transform
        self.depth = depth
        self.buf = collections.deque()
        self.cv = locks.TracedCondition(name="dataloader.ring")
        self.stopped = False
        self.error = None
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        while True:
            with self.cv:
                while len(self.buf) >= self.depth and not self.stopped:
                    self.cv.wait()
                if self.stopped:
                    return
            try:
                item = self.producer()
                if self.transform is not None:
                    item = self.transform(item)
            except BaseException as e:     # surfaced on the next get()
                with self.cv:
                    self.error = e
                    self.cv.notify_all()
                return
            with self.cv:
                self.buf.append(item)
                self.cv.notify_all()

    def _wait_nonempty(self):
        with self.cv:
            while not self.buf and self.error is None and not self.stopped:
                self.cv.wait()
            if not self.buf and self.error is not None:
                raise self.error

    def get(self):
        from . import telemetry
        if telemetry.enabled():
            # ring health: how long the trainer blocked on the producer
            # (wait > 0 means the host pipeline, not the chip, paces the
            # step) and how full the lookahead ran after the pop
            t0 = time.perf_counter()
            self._wait_nonempty()
            telemetry.observe("dataloader.wait_ms",
                              (time.perf_counter() - t0) * 1e3)
            with self.cv:
                item = self.buf.popleft()
                telemetry.set_gauge("dataloader.ring_depth",
                                    len(self.buf))
                self.cv.notify_all()
            return item
        self._wait_nonempty()
        with self.cv:
            item = self.buf.popleft()
            self.cv.notify_all()
        return item

    def peek(self):
        self._wait_nonempty()
        with self.cv:
            return self.buf[0]

    def stop(self):
        with self.cv:
            self.stopped = True
            self.cv.notify_all()
        # join: an in-flight producer() mutates the loader's position
        # state; callers (load_state_dict) reset that state right after
        # stop() and must not race the worker's last write
        if self.thread is not threading.current_thread():
            self.thread.join()


class Dataloader:
    def __init__(self, raw_data, batch_size, name="default", func=None,
                 drop_last=True, shuffle=False, seed=0):
        self.func = func if func else (lambda x: x)
        self.raw_data = np.asarray(self.func(raw_data))
        if self.raw_data.dtype == np.float64:
            self.raw_data = self.raw_data.astype(np.float32)
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        # epoch-seeded permutation: paired loaders (features/labels) with
        # the same length and seed shuffle IDENTICALLY every epoch, keeping
        # (x, y) aligned — the reference pairs loaders implicitly by never
        # reshuffling (dataloader.py seq = arange)
        self.seed = seed
        self._epoch = 0
        self.name = str(name)
        self.dp_rank = None
        self.dp_nrank = None
        self._shard = None
        self.parts = None
        self._initialized = False
        self._ring = None
        self._consumed = 0      # batches handed to the trainer (ring
                                # lookahead excluded) — checkpoint state

    # ---- DP / MP hooks (reference dataloader.py:102-141) ---- #

    def set_dp_rank(self, dp_rank, dp_nrank):
        self.dp_rank = dp_rank
        self.dp_nrank = dp_nrank

    def set_mp_parts(self, cur_part, parts):
        self.cur_part = cur_part
        self.parts = parts

    def set_batch_shard(self, lo, hi):
        """Multi-host: keep only rows [lo, hi) of every (full) batch —
        the rows this process's addressable devices hold under the feed
        sharding.  Epoch/shuffle bookkeeping stays GLOBAL (identical on
        every process), so the union of all processes' shards is exactly
        the single-process batch and trajectories match; each process
        slices, coerces, and copies only 1/P of the bytes
        (reference per-worker dp-sharded loaders, dataloader.py:22-28)."""
        self._shard = (int(lo), int(hi))

    # -------------------------------------------------------- #

    def init_states(self):
        if self._initialized:
            return
        data = self.raw_data
        if self.dp_nrank is not None:
            cur = data.shape[0] // self.dp_nrank
            data = data[cur * self.dp_rank: cur * (self.dp_rank + 1)]
        self.data = data
        self.samples_num = len(data)
        assert self.batch_size <= self.samples_num, (
            f"batch size {self.batch_size} > dataset size {self.samples_num}")
        if self.drop_last:
            self.batch_num = self.samples_num // self.batch_size
        else:
            self.batch_num = int(np.ceil(self.samples_num / self.batch_size))
        self.shape = (self.batch_size,) + self.data.shape[1:]
        self.seq = np.arange(self.samples_num)
        self.index = 0
        self.batch_id = 0
        self._initialized = True

    def _reshuffle(self):
        self._epoch += 1
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            self.seq = rng.permutation(self.samples_num)

    def start_prefetch(self, depth=3, transform=None):
        """Run batch assembly (and ``transform``, e.g.
        :func:`device_transform`) on a background thread feeding a
        bounded ring."""
        if self._ring is not None:
            return
        assert getattr(self, "_peeked", None) is None, (
            "start_prefetch before the first peek/get")
        self.init_states()
        self._ring = _PrefetchRing(self._next_batch, depth, transform)

    def stop_prefetch(self):
        if self._ring is not None:
            self._ring.stop()
            self._ring = None

    def get_arr(self):
        self._consumed += 1
        if self._ring is not None:
            return _ready(self._ring.get())
        if getattr(self, "_peeked", None) is not None:
            batch, self._peeked = self._peeked, None
            return batch
        return self._next_batch()

    # ---- checkpoint state (exact mid-epoch resume; the reference's
    # Dataloader has no state capture, SURVEY §5.4) ---- #

    def state_dict(self):
        return {"consumed": self._consumed, "seed": self.seed,
                "shuffle": self.shuffle}

    def load_state_dict(self, state):
        """Fast-forward to `consumed` batches deterministically: the
        epoch permutation is a pure function of (seed, epoch), so the
        position is computed, not replayed.  A running prefetch ring is
        drained and restarted at the restored position; any lookahead it
        held is discarded."""
        if "seed" in state and state["seed"] != self.seed:
            raise ValueError(
                f"dataloader '{self.name}' checkpoint was written with "
                f"seed={state['seed']}, this loader has seed={self.seed} "
                f"— the replayed shuffle order would silently diverge")
        if "shuffle" in state and bool(state["shuffle"]) != self.shuffle:
            raise ValueError(
                f"dataloader '{self.name}' checkpoint shuffle="
                f"{state['shuffle']} != this loader's {self.shuffle}")
        ring = self._ring
        if ring is not None:
            depth, transform = ring.depth, ring.transform
            self.stop_prefetch()
        self._peeked = None
        self._initialized = False
        self.init_states()
        consumed = int(state["consumed"])
        epoch, within = divmod(consumed, self.batch_num)
        self._epoch = 0
        for _ in range(epoch):
            self._reshuffle()
        self.index = min(within * self.batch_size, self.samples_num)
        self.batch_id = within
        self._consumed = consumed
        if ring is not None:
            self.start_prefetch(depth, transform)

    def peek_arr(self):
        """The batch the next get_arr() will return, without consuming it
        (the executor's PS-embedding prefetch looks ahead one batch,
        reference dataloader.py ring lookahead)."""
        if self._ring is not None:
            return _ready(self._ring.peek())
        if getattr(self, "_peeked", None) is None:
            self._peeked = self._next_batch()
        return self._peeked

    def _next_batch(self):
        self.init_states()
        remaining = self.samples_num - self.index
        if remaining < self.batch_size and not (
                remaining > 0 and not self.drop_last):
            self.index = 0
            self.batch_id = 0
            self._reshuffle()
            remaining = self.samples_num
        size = min(self.batch_size, remaining) if not self.drop_last \
            else self.batch_size
        sel = self.seq[self.index:self.index + size]
        if self._shard is not None and size == self.batch_size:
            # slice BEFORE the gather: only this process's rows are
            # fancy-indexed/copied (partial tails stay global — their
            # row split would not line up with the full-batch sharding)
            sel = sel[self._shard[0]:self._shard[1]]
        batch = self.data[sel]
        self.index += size
        self.batch_id += 1
        if not self.drop_last and self.index >= self.samples_num:
            # partial tail served; next call starts a fresh epoch
            self.index = 0
            self.batch_id = 0
            self._reshuffle()
        return batch

    def get_cur_shape(self):
        return self.shape


class DataloaderOp(Op):
    """Graph node multiplexing named loaders (reference dataloader.py:186).
    The executor recognizes this node, pulls the next host batch for the
    active subgraph name, and feeds it like a placeholder."""

    def __init__(self, dataloaders):
        super().__init__(name="Dataloader")
        norm = []
        for dl in dataloaders:
            if isinstance(dl, (list, tuple)):
                norm.append(Dataloader(*dl))
            else:
                norm.append(dl)
        self.dataloaders = {dl.name: dl for dl in norm}

    def set_dp_rank(self, dp_rank, dp_nrank):
        for dl in self.dataloaders.values():
            dl.set_dp_rank(dp_rank, dp_nrank)

    def set_batch_shard(self, lo, hi):
        for dl in self.dataloaders.values():
            dl.set_batch_shard(lo, hi)

    def get_batch_num(self, name):
        self.dataloaders[name].init_states()
        return self.dataloaders[name].batch_num

    def get_arr(self, name):
        return self.dataloaders[name].get_arr()

    def peek_arr(self, name):
        return self.dataloaders[name].peek_arr()

    def get_cur_shape(self, name):
        self.dataloaders[name].init_states()
        return self.dataloaders[name].get_cur_shape()

    def gradient(self, output_grad):
        return None

    def compute(self, input_vals, tc):
        raise AssertionError("DataloaderOp is fed by the executor")


def dataloader_op(dataloaders):
    """A ``DataloaderOp`` over ``dataloaders`` (``Dataloader`` s, or
    their argument tuples)."""
    return DataloaderOp(dataloaders)


class GNNDataLoaderOp(DataloaderOp):
    """The graph-data loader (reference dataloader.py:147) waits for the
    GNN examples."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GNNDataLoaderOp is not in hetu_tpu_torch yet (ROADMAP A11, "
            "the GNN examples)")
