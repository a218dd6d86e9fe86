"""The NLP entry points of the port run once at a tiny size on the CPU
(at most 2 layers, hidden 64; the trainers' model factories patched to
those widths where the script has no width flags):

- ``train_gpt --data-path``: a ``.txt`` corpus through the wordpiece
  pipeline and a nanoGPT uint16 token file, each with ``--demo-generate``
  logging ``match=True`` (greedy full forwards == ``generate_fast``);
- ``train_bert --data-path --vocab-path --save``, then
  ``finetune_bert_glue --init-checkpoint``: every backbone tensor loads
  (the count equals the backbone's variables) and the classifier stays
  fresh;
- ``finetune_bert_glue`` on the SST-2 and MNLI fixtures (metrics from
  ``compute_metrics``), its ``--data`` route refused (ROADMAP Queue C,
  C7);
- ``finetune_bert_squad`` on ``train-tiny.json``: a falling loss and
  ``squad_evaluate``'s exact match and F1.
"""

import logging
import os
import pickle
import shutil

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

from hetu_tpu_torch import finetune_bert_glue, finetune_bert_squad
from hetu_tpu_torch import train_bert, train_gpt
from hetu_tpu_torch.models import BertConfig, GPTConfig

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
CORPUS = os.path.join(FIX, "tiny_corpus.txt")
VOCAB = os.path.join(FIX, "glue", "vocab.txt")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    # the graph verifier (HETU_VALIDATE) is not in the port yet (A11)
    monkeypatch.setenv("HETU_VALIDATE", "0")

    def gpt(cls, **kw):
        return cls(**dict(dict(hidden_size=64, num_attention_heads=2), **kw))

    def bert(cls, **kw):
        return cls(**dict(dict(hidden_size=64, num_attention_heads=2,
                               intermediate_size=256), **kw))

    monkeypatch.setattr(GPTConfig, "small", classmethod(gpt))
    monkeypatch.setattr(BertConfig, "base", classmethod(bert))


@pytest.mark.parametrize("route", ["txt", "uint16"])
def test_train_gpt_data_path_and_demo_generate(route, tmp_path, caplog):
    if route == "txt":
        # a copy: the route writes its derived vocab beside the corpus
        path = str(tmp_path / "corpus.txt")
        shutil.copy(CORPUS, path)
    else:
        path = str(tmp_path / "train.bin")
        rng = np.random.RandomState(0)
        rng.randint(0, 128, 4096).astype(np.uint16).tofile(path)
    with caplog.at_level(logging.INFO, logger="gpt"):
        losses = train_gpt.main(CPU + [
            "--num-layers", "2", "--vocab-size", "128", "--seq-len", "32",
            "--batch-size", "2", "--num-steps", "3", "--data-path", path,
            "--demo-generate", "5"])
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    text = caplog.text
    assert ("training on text corpus" if route == "txt"
            else f"training on {path}") in text
    assert "match=True" in text


def test_pretrain_save_then_glue_init_checkpoint(tmp_path, caplog):
    ckpt = tmp_path / "pre"
    with caplog.at_level(logging.INFO, logger="bert"):
        last = train_bert.main(CPU + [
            "--num-layers", "1", "--batch-size", "2", "--seq-len", "32",
            "--num-steps", "3", "--data-path", CORPUS, "--vocab-path", VOCAB,
            "--dupe-factor", "2", "--save", str(ckpt)])
    assert np.isfinite(last)
    assert "pretraining on" in caplog.text and "(vocab 167)" in caplog.text
    with open(ckpt / "checkpoint.pkl", "rb") as f:
        params = pickle.load(f)["params"]
    res = finetune_bert_glue.main(CPU + [
        "--task", "sst-2", "--data-dir", os.path.join(FIX, "glue", "SST-2"),
        "--vocab-path", VOCAB, "--num-layers", "1", "--hidden", "64",
        "--heads", "2", "--seq-len", "32", "--batch-size", "8",
        "--num-steps", "4", "--eval-every", "4",
        "--init-checkpoint", str(ckpt)])
    # every backbone tensor came from the checkpoint; its heads did not
    assert res["loaded"] == res["backbone"] > 0
    assert res["loaded"] < len(params)
    assert set(res["metrics"]) == {"accuracy"}


@pytest.mark.parametrize("task,sub", [("sst-2", "SST-2"), ("mnli", "MNLI")])
def test_glue_tasks_run(task, sub):
    res = finetune_bert_glue.main(CPU + [
        "--task", task, "--data-dir", os.path.join(FIX, "glue", sub),
        "--vocab-path", VOCAB, "--num-layers", "1", "--hidden", "32",
        "--heads", "2", "--batch-size", "4", "--seq-len", "24",
        "--num-steps", "4", "--eval-every", "4"])
    assert 0.0 <= res["accuracy"] <= 1.0 and len(res["losses"]) == 4
    assert np.all(np.isfinite(res["losses"]))
    assert res["loaded"] == 0


def test_glue_data_route_names_the_reference_fault(tmp_path):
    tsv = tmp_path / "data.tsv"
    tsv.write_text("1\tgood movie\n0\tbad film\n")
    with pytest.raises(NotImplementedError, match="C7"):
        finetune_bert_glue.main(CPU + ["--data", str(tsv)])


def test_squad_learns_spans():
    res = finetune_bert_squad.main(CPU + [
        "--data", os.path.join(FIX, "squad", "train-tiny.json"),
        "--vocab-path", VOCAB, "--num-layers", "1", "--hidden", "32",
        "--heads", "2", "--batch-size", "8", "--seq-len", "48",
        "--doc-stride", "16", "--num-steps", "60",
        "--learning-rate", "2e-3"])
    losses = res["losses"]
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert 0.0 <= res["exact_match"] <= 100.0 and res["f1"] > 0.0


def test_train_bert_comm_mode_allreduce(caplog):
    """--comm-mode AllReduce runs the plain path, as JAX's executor does;
    PS and Hybrid wait for the parameter server (A10)."""
    args = CPU + ["--num-layers", "1", "--seq-len", "16", "--batch-size",
                  "2", "--num-steps", "2"]
    with caplog.at_level(logging.INFO):
        train_bert.main(args + ["--comm-mode", "AllReduce"])
    for mode in ("PS", "Hybrid"):
        with pytest.raises(NotImplementedError, match="A10"):
            train_bert.main(args + ["--comm-mode", mode])


def test_squad_data_parallel_matches_plain():
    """--comm-mode AllReduce adds DataParallel() (a one-rank dp mesh on
    one process): the same losses as the plain run."""
    argv = CPU + ["--data", os.path.join(FIX, "squad", "train-tiny.json"),
                  "--vocab-path", VOCAB, "--num-layers", "1", "--hidden",
                  "32", "--heads", "2", "--batch-size", "8", "--seq-len",
                  "48", "--doc-stride", "16", "--num-steps", "3"]
    plain = finetune_bert_squad.main(argv)
    dp = finetune_bert_squad.main(argv + ["--comm-mode", "AllReduce"])
    assert dp["losses"] == plain["losses"]
    assert dp["exact_match"] == plain["exact_match"]
