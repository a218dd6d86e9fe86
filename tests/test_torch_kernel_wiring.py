"""The ctypes wiring of the ragged, decode and verify wrappers, checked on
the CPU: every wrapper, in either q dtype, over a float or an int8
cache, at a narrow and a wide q-block, is walked on tensors that report
a CUDA device (their data stays on the CPU; ``_launch`` is replaced by
a recorder, so nothing is built or launched), and each launch's
:func:`ragged_attention.route` is held to the C source of the library
it names: the entry (and its workspace-size entry) is defined there
once, ``extern "C"``, and takes as many parameters, pointer for pointer
and int for int, as ``_launch`` passes.  An argument-count slip between
a wrapper and its C entry would otherwise first show as a crash on the
card."""

import ctypes
import re

import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

from hetu_tpu_torch.kernels import _build
from hetu_tpu_torch.kernels import decode_attention as tda
from hetu_tpu_torch.kernels import ragged_attention as tra
from hetu_tpu_torch.quant import kv_encode

H, DH, BS, T = 2, 32, 16, 4
KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int"}


class OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    CUDA branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _card(t):
    return t.as_subclass(OnCard)


def _c_entries(library):
    """{name: (return type, [parameter kind, ...]), ...} of the ``extern
    "C"`` functions of csrc/<library>.cu, each name defined once."""
    src = (_build.CSRC / f"{library}.cu").read_text()
    out = {}
    for ret, name, params in re.findall(
            r'extern "C" ((?:const )?[\w ]+?\*?) (\w+)\(([^)]*)\)\s*\{', src):
        assert name not in out, f"{library}.cu defines {name} twice"
        kinds = [("pointer" if "*" in p else p.split()[0])
                 for p in (x.strip() for x in params.split(",")) if p]
        out[name] = (ret, kinds)
    return out


def _call(wrapper, dtype, cache, Q, k_off=0):
    """Call ``wrapper`` on CUDA-reporting tensors: q of ``dtype`` (Q rows
    a slot; a decode wrapper one), a pool or slot rows of q's dtype or
    (``cache`` "int8") their ``kv_encode``, three slots of which the last
    has length 0; k's data ``k_off`` bytes past a 16-byte boundary."""
    g = torch.Generator().manual_seed(Q)
    dt = getattr(torch, dtype)
    paged = ("block" in wrapper.__name__
             or wrapper is tra.ragged_paged_attention)
    decode = "decode" in wrapper.__name__
    B = 3
    shape = (1 + B * T, BS, H, DH) if paged else (B, T * BS, H, DH)
    k, v = (torch.randn(shape, generator=g) for _ in range(2))
    sc = {}
    if cache == "int8":
        (k, ks), (v, vs) = kv_encode(k), kv_encode(v)
        sc = dict(k_scale=_card(ks), v_scale=_card(vs))
    else:
        k, v = k.to(dt), v.to(dt)
    n = k_off // k.element_size()
    k = torch.zeros(k.numel() + 16, dtype=k.dtype)[n:n + k.numel()] \
        .view(k.shape).copy_(k)
    assert k.data_ptr() % 16 == k_off
    q = torch.randn((B, Q, H, DH), generator=g).to(dt)
    lengths = torch.tensor([40, Q, 0], dtype=torch.int32)
    args = [_card(q[:, 0] if decode else q), _card(k), _card(v),
            _card(lengths)]
    if not decode:
        args.append(_card(torch.tensor([Q, Q - 1, 0], dtype=torch.int32)))
    if paged:
        tables = torch.arange(1, 1 + B * T, dtype=torch.int32).view(B, T)
        args.append(_card(tables))
    return wrapper(*args, **sc)


WRAPPERS = (tra.ragged_paged_attention, tra.ragged_attention,
            tda.paged_decode_attention, tda.paged_block_decode_attention,
            tda.paged_verify_attention, tda.paged_block_verify_attention)
# (wrapper, q dtype, cache, Q): the ragged and verify wrappers at a
# decode row, the widest narrow block and one past it; the decode
# wrappers at their one row
CASES = [pytest.param(w, dt, cache, Q,
                      id=f"{w.__name__}-{dt}-{cache}-Q{Q}")
         for w in WRAPPERS for dt in ("float32", "bfloat16")
         for cache in ("float", "int8")
         for Q in ((1,) if "decode" in w.__name__ else (1, 16, 17))]


@pytest.fixture
def routes(monkeypatch):
    """The :class:`ragged_attention.Route` of each ``_launch`` call, in
    order; the call returns an empty output like q."""
    seen = []

    def record(source, entry, name, q, kv, rest, ints, span):
        seen.append(tra.route(source, entry, name, q, kv, rest, ints))
        return torch.empty_like(q)
    monkeypatch.setattr(tra, "_launch", record)
    monkeypatch.setattr(tda, "_launch", record)
    return seen


@pytest.mark.parametrize("wrapper,dtype,cache,Q", CASES)
def test_every_route_matches_its_c_entry(routes, wrapper, dtype, cache, Q):
    """Each launch names a library of ``csrc/``, and an entry of it whose
    parameters are, kind for kind, the ``argtypes`` ``_launch`` sets
    (the pointers, the shapes and any dtype code, the stream); a
    workspace-size entry, where the route takes one, returns ``long
    long`` from the five ints ``_launch`` passes.  A verify block past
    16 rows launches once per 16-row group."""
    out = _call(wrapper, dtype, cache, Q)
    assert out.shape[0] == 3 and out.dtype == getattr(torch, dtype)
    verify = "verify" in wrapper.__name__
    assert len(routes) == (-(-Q // 16) if verify else 1)
    for r in routes:
        assert r.library in _build.SOURCES
        entries = _c_entries(r.library)
        assert r.entry in entries, f"{r.library}.cu has no {r.entry}"
        ret, kinds = entries[r.entry]
        assert ret == "int"
        assert kinds == [KINDS[t] for t in r.argtypes], (
            f"{r.library}.cu {r.entry} takes {kinds}, _launch passes "
            f"{[KINDS[t] for t in r.argtypes]}")
        if r.ws_entry is not None:
            assert entries[r.ws_entry] == (
                "long long", [KINDS[t] for t in tra._WS_ARGTYPES])
        assert r.name == wrapper.__name__ + ("_int8" if cache == "int8"
                                             else "")


def _split_route(wrapper, cache):
    """(library, entry, workspace entry, tail) of an f32-q decode or
    verify call on the split-K entries of ``decode_attention`` /
    ``decode_attention_int8``."""
    int8 = cache == "int8"
    return (("decode_attention_int8" if int8 else "decode_attention"),
            "hetu_" + wrapper.__name__ + ("_int8" if int8 else ""),
            "hetu_decode_f32_workspace", ())


@pytest.mark.parametrize("wrapper", [tda.paged_verify_attention,
                                     tda.paged_block_verify_attention])
@pytest.mark.parametrize("cache", ["float", "int8"])
@pytest.mark.parametrize("Q", [1, 5, 16, 17, 33])
def test_f32_verify_runs_the_split_body(routes, wrapper, cache, Q):
    """f32 K6/K7 and their f32-q int8 twins run the split-K entries of
    ``decode_attention`` / ``decode_attention_int8`` at every Q (a block
    past 16 rows in 16-row groups): a workspace from the library's
    ``hetu_decode_f32_workspace`` and no dtype argument (16-byte aligned
    data, as every route: ``test_every_route_refuses_misaligned_data``)."""
    _call(wrapper, "float32", cache, Q)
    assert len(routes) == -(-Q // 16)
    for r in routes:
        assert (r.library, r.entry, r.ws_entry, r.tail) == \
            _split_route(wrapper, cache)


@pytest.mark.parametrize("wrapper", [tda.paged_decode_attention,
                                     tda.paged_block_decode_attention])
@pytest.mark.parametrize("cache", ["float", "int8"])
def test_f32_decode_runs_the_split_body(routes, wrapper, cache):
    """f32 K4/K5 and their f32-q int8 twins run the split-K entries of
    ``decode_attention`` / ``decode_attention_int8``, one launch a call:
    a workspace from the library's ``hetu_decode_f32_workspace`` and no
    dtype argument; the wrapper passes q as one row, [B, 1, H, Dh]."""
    _call(wrapper, "float32", cache, 1)
    assert [(r.library, r.entry, r.ws_entry, r.tail) for r in routes] == \
        [_split_route(wrapper, cache)]


@pytest.mark.parametrize("wrapper,dtype,cache,Q", CASES)
def test_every_route_refuses_misaligned_data(monkeypatch, wrapper, dtype,
                                             cache, Q):
    """Every body copies 16-byte chunks: a K cache 8 bytes off a 16-byte
    boundary raises ValueError in ``_launch`` before any library is
    loaded; the same cache on a boundary goes on to load the library of
    its route."""
    loaded = []

    class Loaded(Exception):
        pass

    def load(name):
        loaded.append(name)
        raise Loaded(name)
    monkeypatch.setattr(_build, "library", load)
    with pytest.raises(Loaded):
        _call(wrapper, dtype, cache, Q)
    assert len(loaded) == 1 and loaded[0] in _build.SOURCES
    loaded.clear()
    with pytest.raises(ValueError, match="16-byte"):
        _call(wrapper, dtype, cache, Q, k_off=8)
    assert loaded == []
