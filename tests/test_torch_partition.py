"""The port's pipeline partitioner (``hetu_tpu_torch.parallel.partition``)
against the JAX package's on the same models built in each package: the
cut blocks (node count, the op of the boundary by its base name, closed
or not, params), the body (block count and per-block param names), the
pre and post params and feeds, and the body entry's topo position.

Models: the residual MLP of tests/test_pipeline_executor.py at several
stage counts (the body trimmed to a multiple of S), its shared-weight and
non-uniform variants, the tiny BERT-4L of ``TestBert4L``, and layers
that differ only in a constant tensor (the fingerprint reads closure
constants by their bytes: a torch tensor in the port, a numpy array in
JAX)."""

import os
import re

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import hetu_tpu as jht
import hetu_tpu_torch.graph as tht
from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
from hetu_tpu.models.bert import BertConfig as JBertConfig
from hetu_tpu.models.bert import \
    BertForSequenceClassification as JBertClassifier
from hetu_tpu.parallel.partition import partition as jpartition
from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
from hetu_tpu_torch.models import BertConfig as TBertConfig
from hetu_tpu_torch.models import \
    BertForSequenceClassification as TBertClassifier
from hetu_tpu_torch.parallel.partition import partition as tpartition

IN, HID, OUT = 8, 16, 4


@pytest.fixture(autouse=True)
def _no_validate(monkeypatch):
    monkeypatch.setenv("HETU_VALIDATE", "0")


def mlp(ht, n_layers=4):
    """tests/test_pipeline_executor.py's residual MLP: its loss."""
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    h = ht.linear_op(x, ht.init.xavier_uniform((IN, HID), name="in_w"),
                     ht.init.zeros((HID,), name="in_b"))
    for i in range(n_layers):
        w1 = ht.init.xavier_uniform((HID, 2 * HID), name=f"l{i}_w1")
        b1 = ht.init.zeros((2 * HID,), name=f"l{i}_b1")
        w2 = ht.init.xavier_uniform((2 * HID, HID), name=f"l{i}_w2")
        b2 = ht.init.zeros((HID,), name=f"l{i}_b2")
        h = h + ht.linear_op(ht.gelu_op(ht.linear_op(h, w1, b1)), w2, b2)
    logits = ht.matmul_op(h, ht.init.xavier_uniform((HID, OUT),
                                                    name="head_w"))
    return ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y), axes=0)


def shared(ht):
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    w = ht.init.xavier_uniform((IN, IN), name="shared_w")
    h = x
    for _ in range(4):
        h = ht.gelu_op(ht.matmul_op(h, w))
    return ht.reduce_mean_op(ht.softmaxcrossentropy_op(
        ht.matmul_op(h, ht.init.xavier_uniform((IN, OUT), name="hw")), y),
        axes=0)


def nonuniform(ht):
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    h = ht.gelu_op(ht.matmul_op(
        x, ht.init.xavier_uniform((IN, HID), name="a")))
    h = ht.tanh_op(ht.matmul_op(
        h, ht.init.xavier_uniform((HID, HID), name="b")))
    return ht.reduce_mean_op(ht.softmaxcrossentropy_op(
        ht.matmul_op(h, ht.init.xavier_uniform((HID, OUT), name="c")), y),
        axes=0)


def bert4l(ht, cfg_cls, model_cls):
    """TestBert4L's sizes, built at the microbatch size."""
    cfg = cfg_cls(vocab_size=100, hidden_size=32, num_hidden_layers=4,
                  num_attention_heads=2, intermediate_size=64, seq_len=16,
                  batch_size=2, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
    ids, labels = ht.placeholder_op("input_ids"), ht.placeholder_op("labels")
    loss, _ = model_cls(cfg, num_labels=3)(ids, labels=labels)
    return loss


def constants(ht, consts):
    """Layers h = gelu(h W_i) + c_i that differ only in the constant."""
    x, y = ht.placeholder_op("x"), ht.placeholder_op("y")
    h = ht.matmul_op(x, ht.init.xavier_uniform((IN, HID), name="k_in"))
    for i, c in enumerate(consts):
        w = ht.init.xavier_uniform((HID, HID), name=f"k{i}_w")
        h = ht.addbyconst_op(ht.gelu_op(ht.matmul_op(h, w)), c)
    return ht.reduce_mean_op(ht.softmaxcrossentropy_op(
        ht.matmul_op(h, ht.init.xavier_uniform((HID, OUT), name="k_head")),
        y), axes=0)


def _base(node):
    return re.sub(r"_\d+$", "", node.name)


def summary(plan, topo):
    pos = {id(n): i for i, n in enumerate(topo)}
    names = lambda ns: [n.name for n in ns]          # noqa: E731
    return dict(
        uniform=plan.uniform, n_body=plan.num_body_blocks(),
        blocks=[(len(b.nodes), _base(b.boundary_out), b.closed,
                 names(b.params), names(b.feeds)) for b in plan.blocks],
        body=[names(ps) for ps in plan.body_params],
        pre=names(plan.pre_params), post=names(plan.post_params),
        pre_feeds=names(plan.pre_feeds), post_feeds=names(plan.post_feeds),
        entry=None if plan.body_entry is None else pos[id(plan.body_entry)],
        pre_nodes=len(plan.pre_nodes), post_nodes=len(plan.post_nodes))


def both(build_j, build_t, S):
    jl, tl = build_j(), build_t()
    return (summary(jpartition(jl, S), jtopo([jl])),
            summary(tpartition(tl, S), ttopo([tl])))


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_mlp_plans_equal_jax(S):
    want, got = both(lambda: mlp(jht), lambda: mlp(tht), S)
    assert got == want
    if S > 1:
        assert got["uniform"] and got["n_body"] == (4 // S) * S
        assert got["body"][0] == ["l0_w1", "l0_b1", "l0_w2", "l0_b2"] \
            or S == 3


@pytest.mark.parametrize("build", [shared, nonuniform],
                         ids=["shared_weight", "nonuniform"])
def test_variants_equal_jax(build):
    want, got = both(lambda: build(jht), lambda: build(tht), 2)
    assert got == want
    assert not got["uniform"] and len(got["blocks"]) >= 2


def test_bert4l_plan_equals_jax():
    want, got = both(lambda: bert4l(jht, JBertConfig, JBertClassifier),
                     lambda: bert4l(tht, TBertConfig, TBertClassifier), 2)
    assert got == want
    assert got["uniform"] and got["n_body"] == 4
    assert got["body"][3][0].startswith("bert_layer3_")


@pytest.mark.parametrize("same", [True, False], ids=["equal", "differ"])
def test_constant_tensors_split_the_body(same):
    rng = np.random.RandomState(0)
    base = rng.randn(HID).astype(np.float32)
    consts = [base if same else base + i for i in range(4)]
    want, got = both(lambda: constants(jht, consts),
                     lambda: constants(tht, [torch.from_numpy(c)
                                             for c in consts]), 2)
    assert got == want
    assert got["uniform"] == same
