"""The port's copies of the JAX package's data modules against the
originals, on the same inputs, exactly:

- ``tokenizers``: wordpiece ids of the fixture corpus and of text with
  accents, CJK, punctuation and unknown words; ``encode`` of pairs.
- ``pretraining_data``: the vocab file ``build_wordpiece_vocab`` writes,
  the token stream, every array of ``create_bert_pretraining_data`` and
  ``create_gpt_pretraining_data``, and ``PretrainingBatches``' batches.
- ``glue``: the arrays of the four fixture tasks and ``compute_metrics``.
- ``squad``: examples, features, arrays, predictions and EM/F1.
- ``metrics``: every function on seeded inputs.
- ``data``: the synthetic fallbacks and the MNIST, CIFAR, Criteo, Adult
  and MovieLens loaders on files the tests write.
"""

import gzip
import os
import pickle

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

from hetu_tpu import data as jdata
from hetu_tpu import glue as jglue
from hetu_tpu import metrics as jmetrics
from hetu_tpu import pretraining_data as jpd
from hetu_tpu import squad as jsquad
from hetu_tpu import tokenizers as jtok
from hetu_tpu_torch import data as tdata
from hetu_tpu_torch import glue as tglue
from hetu_tpu_torch import metrics as tmetrics
from hetu_tpu_torch import pretraining_data as tpd
from hetu_tpu_torch import squad as tsquad
from hetu_tpu_torch import tokenizers as ttok

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
CORPUS = os.path.join(FIX, "tiny_corpus.txt")
VOCAB = os.path.join(FIX, "glue", "vocab.txt")
SQUAD = os.path.join(FIX, "squad")


def _same(a, b, what=""):
    """Equal arrays (dtype and shape included), or equal trees of them."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


TEXTS = ["Héllo, wörld! The cat's naïve café.", "unaffable running jumped",
         "中文 字符 mixed with ASCII", "tabs\tand\nnewlines  spaces",
         "zzqx unknownword [MASK] [SEP]"]


def test_tokenizer_ids_and_encode_equal_jax():
    jt, tt = (m.BertTokenizer.from_pretrained(VOCAB) for m in (jtok, ttok))
    lines = open(CORPUS, encoding="utf-8").read().splitlines() + TEXTS
    for line in lines:
        assert tt.tokenize(line) == jt.tokenize(line), line
        assert tt.convert_tokens_to_ids(tt.tokenize(line)) == \
            jt.convert_tokens_to_ids(jt.tokenize(line))
    for a, b in zip(TEXTS, TEXTS[1:] + [None]):
        assert tt.encode(a, b, max_length=24) == jt.encode(a, b,
                                                           max_length=24)
    assert ttok.load_vocab(VOCAB) == jtok.load_vocab(VOCAB)
    assert ttok.whitespace_tokenize(TEXTS[3]) == \
        jtok.whitespace_tokenize(TEXTS[3])


def test_vocab_file_and_token_stream_equal_jax(tmp_path):
    outs = []
    for m, name in ((jpd, "j"), (tpd, "t")):
        path = tmp_path / f"{name}_vocab.txt"
        m.build_wordpiece_vocab(CORPUS, str(path), max_words=120)
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    jt = jpd.load_or_build_tokenizer(CORPUS, VOCAB)
    tt = tpd.load_or_build_tokenizer(CORPUS, VOCAB)
    _same(tpd.corpus_token_stream(CORPUS, tt),
          jpd.corpus_token_stream(CORPUS, jt))
    assert tpd.read_documents(CORPUS, tt) == jpd.read_documents(CORPUS, jt)


@pytest.mark.parametrize("seq,seed", [(32, 1), (64, 12345)])
def test_pretraining_arrays_and_batches_equal_jax(seq, seed):
    jt = jpd.load_or_build_tokenizer(CORPUS, VOCAB)
    tt = tpd.load_or_build_tokenizer(CORPUS, VOCAB)
    kw = dict(max_seq_length=seq, dupe_factor=3, seed=seed)
    jb = jpd.create_bert_pretraining_data(CORPUS, jt, **kw)
    tb = tpd.create_bert_pretraining_data(CORPUS, tt, **kw)
    _same(tb, jb, "bert")
    _same(tpd.create_gpt_pretraining_data(CORPUS, tt, seq_len=seq),
          jpd.create_gpt_pretraining_data(CORPUS, jt, seq_len=seq), "gpt")
    jit_, tit = (iter(m.PretrainingBatches(d, 4, seed=seed))
                 for m, d in ((jpd, jb), (tpd, tb)))
    for i, (a, b) in enumerate(zip(jit_, tit)):
        _same(b, a, f"batch {i}")


@pytest.mark.parametrize("task,sub", [("cola", "CoLA"), ("sst-2", "SST-2"),
                                      ("mrpc", "MRPC"), ("mnli", "MNLI")])
def test_glue_arrays_and_metrics_equal_jax(task, sub):
    d = os.path.join(FIX, "glue", sub)
    jt, tt = (m.BertTokenizer.from_pretrained(VOCAB) for m in (jtok, ttok))
    jp, tp = jglue.PROCESSORS[task](), tglue.PROCESSORS[task]()
    assert tp.get_labels() == jp.get_labels()
    for split in ("get_train_examples", "get_dev_examples"):
        je, te = getattr(jp, split)(d), getattr(tp, split)(d)
        assert [(e.guid, e.text_a, e.text_b, e.label) for e in te] == \
            [(e.guid, e.text_a, e.text_b, e.label) for e in je]
        _same(tglue.convert_examples_to_arrays(te, tp.get_labels(), 24, tt),
              jglue.convert_examples_to_arrays(je, jp.get_labels(), 24, jt),
              f"{task} {split}")
    rng = np.random.RandomState(3)
    preds = rng.randint(0, len(jp.get_labels()), 40)
    gold = rng.randint(0, len(jp.get_labels()), 40)
    assert tglue.compute_metrics(task, preds, gold) == \
        jglue.compute_metrics(task, preds, gold)


def _fields(obj):
    return {k: getattr(obj, k) for k in type(obj).__slots__}


@pytest.mark.parametrize("name,training", [("train-tiny.json", True),
                                           ("dev-tiny-v2.json", False)])
def test_squad_features_predictions_and_scores_equal_jax(name, training):
    path = os.path.join(SQUAD, name)
    je = jsquad.read_squad_examples(path, is_training=training)
    te = tsquad.read_squad_examples(path, is_training=training)
    assert [_fields(e) for e in te] == [_fields(e) for e in je]
    jt, tt = (m.BertTokenizer.from_pretrained(VOCAB) for m in (jtok, ttok))
    kw = dict(max_seq_length=48, doc_stride=16, max_query_length=16,
              is_training=training)
    jf = jsquad.convert_examples_to_features(je, jt, **kw)
    tf = tsquad.convert_examples_to_features(te, tt, **kw)
    assert [_fields(f) for f in tf] == [_fields(f) for f in jf]
    _same(tsquad.features_to_arrays(tf), jsquad.features_to_arrays(jf))
    rng = np.random.RandomState(7)
    s = rng.randn(len(jf), 48).astype(np.float32)
    e = rng.randn(len(jf), 48).astype(np.float32)
    jpred = jsquad.extract_predictions(je, jf, s, e)
    tpred = tsquad.extract_predictions(te, tf, s, e)
    assert tpred == jpred
    assert tsquad.squad_evaluate(te, tpred) == jsquad.squad_evaluate(je, jpred)
    gold = {ex.qas_id: (ex.answers[0] if ex.answers else "") for ex in je}
    assert tsquad.squad_evaluate(te, gold) == jsquad.squad_evaluate(je, gold)


def test_metrics_equal_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(64, 5).astype(np.float32)
    labels = rng.randint(0, 5, 64)
    onehot = np.eye(5, dtype=np.float32)[labels]
    p = rng.rand(200).astype(np.float32)
    y = (rng.rand(200) < 0.4).astype(np.float32)
    for fn in ("accuracy",):
        for yt in (labels, onehot):
            assert getattr(tmetrics, fn)(logits, yt) == \
                getattr(jmetrics, fn)(logits, yt)
    for fn in ("precision", "recall", "f1_score", "auc_score",
               "pr_auc_score"):
        assert getattr(tmetrics, fn)(p, y) == getattr(jmetrics, fn)(p, y), fn
    _same(tmetrics.softmax_np(logits), jmetrics.softmax_np(logits))
    ja, ta = jmetrics.Accuracy(), tmetrics.Accuracy()
    for i in range(0, 64, 16):
        ja.update(logits[i:i + 16], labels[i:i + 16])
        ta.update(logits[i:i + 16], labels[i:i + 16])
    assert ta.result() == ja.result()


def _write_criteo(path, rng, n=40):
    with open(path / "train.txt", "w") as f:
        for _ in range(n):
            dense = [str(rng.randint(-2, 50)) if rng.rand() > 0.1 else ""
                     for _ in range(13)]
            cats = [f"{rng.randint(0, 7):08x}" if rng.rand() > 0.1 else ""
                    for _ in range(26)]
            f.write("\t".join([str(rng.randint(0, 2))] + dense + cats)
                    + "\n")


def _write_adult(path, rng, n=30):
    cats = {"workclass": ["Private", "State-gov"], "education":
            ["Bachelors", "HS-grad"], "marital_status": ["Never", "Married"],
            "occupation": ["Tech", "Sales", "Craft"], "relationship":
            ["Husband", "Wife"], "race": ["White", "Black"], "gender":
            ["Male", "Female"], "native_country": ["US", "Cuba"]}
    with open(path / "train.csv", "w") as f:
        f.write(",".join(jdata._ADULT_COLUMNS) + "\n")
        for _ in range(n):
            row = {c: rng.choice(v) for c, v in cats.items()}
            row.update(age=str(rng.randint(17, 90)),
                       fnlwgt=str(rng.randint(1e4, 1e6)),
                       education_num=str(rng.randint(1, 16)),
                       capital_gain=str(rng.randint(0, 5000)),
                       capital_loss=str(rng.randint(0, 300)),
                       hours_per_week=str(rng.randint(10, 60)),
                       income_bracket=rng.choice(["<=50K", ">50K"]))
            f.write(", ".join(row[c] for c in jdata._ADULT_COLUMNS) + "\n")


def _write_movielens(path, rng, dat):
    rows = [(u, rng.randint(1, 30), rng.randint(0, 6), rng.randint(1e8))
            for u in range(1, 9) for _ in range(rng.randint(2, 6))]
    if dat:
        text = "\n".join("::".join(map(str, r)) for r in rows)
        (path / "ratings.dat").write_text(text + "\n")
    else:
        text = "\n".join(",".join(map(str, r)) for r in rows)
        (path / "ratings.csv").write_text(
            "userId,movieId,rating,timestamp\n" + text + "\n")


def test_data_loaders_equal_jax(tmp_path):
    rng = np.random.RandomState(11)
    # synthetic fallbacks (no files) and one_hot / normalize_cifar
    missing = str(tmp_path / "none")
    _same(tdata.mnist(missing, n_train=64, n_valid=16),
          jdata.mnist(missing, n_train=64, n_valid=16), "mnist synth")
    for fn in ("cifar10", "cifar100"):
        _same(getattr(tdata, fn)(missing, n_train=32, n_valid=8),
              getattr(jdata, fn)(missing, n_train=32, n_valid=8), fn)
    x = rng.rand(4, 3, 32, 32).astype(np.float32)
    _same(tdata.normalize_cifar(x), jdata.normalize_cifar(x))
    _same(tdata.one_hot([3, 0, 2], 5), jdata.one_hot([3, 0, 2], 5))
    # MNIST and CIFAR-10 files
    mn = tmp_path / "mnist.pkl.gz"
    split = [(rng.rand(n, 784).astype(np.float32), rng.randint(0, 10, n))
             for n in (20, 8, 8)]
    with gzip.open(mn, "wb") as f:
        pickle.dump(tuple(split), f)
    _same(tdata.mnist(str(mn)), jdata.mnist(str(mn)), "mnist file")
    cif = tmp_path / "cifar"
    cif.mkdir()
    for fn in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cif / fn, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (4, 3072),
                                              dtype=np.uint8),
                         b"labels": list(rng.randint(0, 10, 4))}, f)
    _same(tdata.cifar10(str(cif)), jdata.cifar10(str(cif)), "cifar10 file")
    # Criteo raw text, then its preprocessed arrays
    cr = tmp_path / "criteo"
    cr.mkdir()
    _write_criteo(cr, rng)
    for kw in ({}, {"nrows": 17}, {"return_val": True}):
        _same(tdata.load_criteo(str(cr), **kw),
              jdata.load_criteo(str(cr), **kw), f"criteo {kw}")
    d, s, y = jdata.load_criteo(str(cr))
    for name, a in (("dense", d), ("sparse", s), ("labels", y)):
        np.save(cr / f"sampled_{name}_feats.npy" if name != "labels"
                else cr / "sampled_labels.npy", a)
    _same(tdata.load_criteo(str(cr)), jdata.load_criteo(str(cr)), "npy")
    # Adult and MovieLens
    ad = tmp_path / "adult"
    ad.mkdir()
    _write_adult(ad, rng)
    _same(tdata.load_adult(str(ad)), jdata.load_adult(str(ad)), "adult")
    for dat in (False, True):
        ml = tmp_path / f"ml{int(dat)}"
        ml.mkdir()
        _write_movielens(ml, rng, dat)
        _same(tdata.load_movielens(str(ml), seed=5),
              jdata.load_movielens(str(ml), seed=5), f"movielens {dat}")
    for fn in ("load_criteo", "load_adult", "load_movielens"):
        with pytest.raises(FileNotFoundError):
            getattr(tdata, fn)(missing)
