"""Dataset helpers: mnist/cifar10/cifar100 + one-hot utils, and the
Criteo, Adult and MovieLens loaders: the port's copy of the JAX
package's ``hetu_tpu/data.py``; the data home comes from the port's own
``envvars`` (``HETU_DATA_HOME``).

Reference: python/hetu/data.py:5-153 (downloads + normalization).  Network
egress may be unavailable; loaders look for local files first and fall back
to deterministic synthetic data shaped exactly like the real set so
benchmarks and tests run hermetically (the reference's accuracy numbers
obviously require the real data).
"""

from __future__ import annotations

import gzip
import os
import pickle

from . import envvars

import numpy as np

_DATA_HOME = envvars.get_path("HETU_DATA_HOME")


def one_hot(labels, num_classes):
    labels = np.asarray(labels, np.int64).reshape(-1)
    out = np.zeros((len(labels), num_classes), np.float32)
    out[np.arange(len(labels)), labels] = 1.0
    return out


def normalize_cifar(x):
    mean = np.array([0.4914, 0.4822, 0.4465], np.float32).reshape(1, 3, 1, 1)
    std = np.array([0.2470, 0.2435, 0.2616], np.float32).reshape(1, 3, 1, 1)
    return (x - mean) / std


def _synthetic(n, shape, num_classes, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *shape).astype(np.float32)
    y = rng.randint(0, num_classes, size=(n,))
    return x, y


def mnist(path=None, onehot=True, n_train=60000, n_valid=10000):
    """Returns (train_x, train_y, valid_x, valid_y); x flat (N, 784)."""
    path = path or os.path.join(_DATA_HOME, "mnist.pkl.gz")
    if os.path.exists(path):
        with gzip.open(path, "rb") as f:
            train, valid, _test = pickle.load(f, encoding="latin1")
        tx, ty = train
        vx, vy = valid
    else:
        tx, ty = _synthetic(n_train, (784,), 10, 0)
        vx, vy = _synthetic(n_valid, (784,), 10, 1)
    if onehot:
        ty, vy = one_hot(ty, 10), one_hot(vy, 10)
    return tx.astype(np.float32), ty, vx.astype(np.float32), vy


def _load_cifar_batches(dirname, files):
    xs, ys = [], []
    for fn in files:
        with open(os.path.join(dirname, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels" if b"labels" in d else b"fine_labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
    return x, np.asarray(ys)


def cifar10(path=None, onehot=True, n_train=50000, n_valid=10000):
    """Returns (train_x, train_y, valid_x, valid_y); x (N, 3, 32, 32)."""
    path = path or os.path.join(_DATA_HOME, "cifar-10-batches-py")
    if os.path.isdir(path):
        tx, ty = _load_cifar_batches(
            path, [f"data_batch_{i}" for i in range(1, 6)])
        vx, vy = _load_cifar_batches(path, ["test_batch"])
        tx, vx = normalize_cifar(tx), normalize_cifar(vx)
    else:
        tx, ty = _synthetic(n_train, (3, 32, 32), 10, 0)
        vx, vy = _synthetic(n_valid, (3, 32, 32), 10, 1)
    if onehot:
        ty, vy = one_hot(ty, 10), one_hot(vy, 10)
    return tx, ty, vx, vy


def cifar100(path=None, onehot=True, n_train=50000, n_valid=10000):
    path = path or os.path.join(_DATA_HOME, "cifar-100-python")
    if os.path.isdir(path):
        tx, ty = _load_cifar_batches(path, ["train"])
        vx, vy = _load_cifar_batches(path, ["test"])
        tx, vx = normalize_cifar(tx), normalize_cifar(vx)
    else:
        tx, ty = _synthetic(n_train, (3, 32, 32), 100, 0)
        vx, vy = _synthetic(n_valid, (3, 32, 32), 100, 1)
    if onehot:
        ty, vy = one_hot(ty, 100), one_hot(vy, 100)
    return tx, ty, vx, vy


# --------------------------------------------------------------------- #
# Real-dataset parsers: read reference-format local
# files when present; callers keep their synthetic fallbacks.  Formats
# match the reference's examples/ctr/models/load_data.py and
# examples/rec/movielens.py so files prepared for the reference drop in
# unchanged.  Pure numpy/csv — no pandas/sklearn dependency.
# --------------------------------------------------------------------- #

def _label_encode_columns(cols):
    """Per-column label-encode with CUMULATIVE offsets (reference
    process_sparse_feats: each column's ids live in a disjoint range, so
    one flat embedding table serves all fields).  Vectorized via
    np.unique — a Python dict loop is unusable at Criteo scale (45.8M
    rows x 26 columns)."""
    out = np.empty((len(cols[0]), len(cols)), np.int32)
    offset = 0
    for j, col in enumerate(cols):
        uniq, inv = np.unique(np.asarray(col), return_inverse=True)
        out[:, j] = inv + offset
        offset += len(uniq)
    return out, offset


def load_criteo(path, nrows=None, return_val=False):
    """Criteo display-advertising data from ``path``.

    Accepted layouts (reference load_data.py):
      * preprocessed arrays ``train_dense_feats.npy`` /
        ``train_sparse_feats.npy`` / ``train_labels.npy``
        (+ ``test_*`` when ``return_val``) — process_all_criteo_data;
      * ``sampled_dense_feats.npy``/... — process_sampled_criteo_data;
      * raw ``train.txt`` (tab-separated, no header: label, 13 ints,
        26 hex categoricals) or ``train.csv`` (same with header) —
        dense gets log(x+1) for x > -1, categoricals label-encode with
        cumulative offsets (process_dense_feats/process_sparse_feats).

    Returns ``(dense [N,13] f32, sparse [N,26] i32, labels [N,1] f32)``
    (tuples of train/test arrays per position when ``return_val``).
    Raises FileNotFoundError when nothing usable is present — callers
    keep their synthetic fallback.
    """
    pre = [os.path.join(path, f) for f in (
        "train_dense_feats.npy", "train_sparse_feats.npy",
        "train_labels.npy")]
    if all(os.path.exists(p) for p in pre):
        train = [np.load(p) for p in pre]
        if return_val:
            test = [np.load(os.path.join(path, f)) for f in (
                "test_dense_feats.npy", "test_sparse_feats.npy",
                "test_labels.npy")]
            return tuple(zip(train, test))
        return tuple(train)
    sampled = [os.path.join(path, f) for f in (
        "sampled_dense_feats.npy", "sampled_sparse_feats.npy",
        "sampled_labels.npy")]
    if all(os.path.exists(p) for p in sampled):
        return tuple(np.load(p) for p in sampled)

    txt = os.path.join(path, "train.txt")
    csvf = os.path.join(path, "train.csv")
    if os.path.exists(txt):
        rows_iter = (line.rstrip("\n").split("\t") for line in open(txt))
    elif os.path.exists(csvf):
        import csv as _csv
        rdr = _csv.reader(open(csvf))
        next(rdr)                       # header
        rows_iter = rdr
    else:
        raise FileNotFoundError(
            f"no criteo data under {path!r} (expected train_*.npy, "
            f"sampled_*.npy, train.txt or train.csv)")
    labels, dense, sparse_raw = [], [], []
    for i, parts in enumerate(rows_iter):
        if nrows is not None and i >= nrows:
            break
        labels.append(float(parts[0] or 0))
        dense.append([float(v) if v not in ("", None) else 0.0
                      for v in parts[1:14]])
        sparse_raw.append([v or "-1" for v in parts[14:40]])
    dense = np.asarray(dense, np.float32)
    dense = np.where(dense > -1, np.log(dense + 1,
                                        where=dense > -1), -1.0)
    sparse, _ = _label_encode_columns(
        [np.array([r[j] for r in sparse_raw]) for j in range(26)])
    labels = np.asarray(labels, np.float32).reshape(-1, 1)
    out = (dense.astype(np.float32), sparse, labels)
    if return_val:
        n_test = max(len(labels) // 10, 1)
        return tuple((a[:-n_test], a[-n_test:]) for a in out)
    return out


_ADULT_COLUMNS = [
    "age", "workclass", "fnlwgt", "education", "education_num",
    "marital_status", "occupation", "relationship", "race", "gender",
    "capital_gain", "capital_loss", "hours_per_week", "native_country",
    "income_bracket"]
_ADULT_EMBED = ["workclass", "education", "marital_status", "occupation",
                "relationship", "race", "gender", "native_country"]
_ADULT_CONT = ["age", "capital_gain", "capital_loss", "hours_per_week"]
_ADULT_CROSS = (("education", "occupation"),
                ("native_country", "occupation"))
WDL_ADULT_WIDE_DIM = 809


def load_adult(path, wide_dim=WDL_ADULT_WIDE_DIM):
    """Adult census data for wdl_adult: ``train.csv`` (and optionally
    ``test.csv``) under ``path`` in the UCI adult.data column layout
    (reference maybe_download COLUMNS; files may carry a header).

    Returns ``(X_deep [N,12] f32, X_wide [N,wide_dim] f32, y [N,2])``:
    X_deep = 8 label-encoded embedding columns + 4 standardized
    continuous (reference load_adult_data deep_cols order); X_wide =
    one-hot of the wide columns (categoricals + age bucket + the two
    crossed columns).  The reference's fitted one-hot happens to span
    809 dims on the full UCI set; other files yield a different span, so
    the encoding is padded/truncated to ``wide_dim`` to keep the
    wdl_adult contract.
    """
    import csv as _csv
    f = os.path.join(path, "train.csv")
    if not os.path.exists(f):
        raise FileNotFoundError(f"no {f}")
    rows = []
    with open(f) as fh:
        for parts in _csv.reader(fh, skipinitialspace=True):
            if not parts or parts[0] == "age":
                continue                       # header / blank
            if len(parts) < len(_ADULT_COLUMNS):
                continue
            rows.append(dict(zip(_ADULT_COLUMNS, parts)))
    col = {c: np.array([r[c] for r in rows]) for c in _ADULT_COLUMNS}
    y = np.array([1 if ">50K" in v else 0
                  for v in col["income_bracket"]], np.int32)
    # deep: embeddings + standardized continuous
    embed, _ = _label_encode_columns([col[c] for c in _ADULT_EMBED])
    cont = np.stack([col[c].astype(np.float32)
                     for c in _ADULT_CONT], axis=1)
    cont = (cont - cont.mean(axis=0)) / (cont.std(axis=0) + 1e-8)
    x_deep = np.concatenate([embed.astype(np.float32), cont], axis=1)
    # wide: one-hot of categoricals + age bucket + crossed columns
    age = col["age"].astype(np.float32)
    age_group = np.digitize(age, [25, 65]).astype(str)
    wide_cols = [col[c] for c in _ADULT_EMBED] + [age_group]
    for a, b in _ADULT_CROSS:
        wide_cols.append(np.char.add(np.char.add(
            col[a].astype(str), "-"), col[b].astype(str)))
    enc, total = _label_encode_columns(wide_cols)
    x_wide = np.zeros((len(rows), max(total, wide_dim)), np.float32)
    x_wide[np.arange(len(rows))[:, None], enc] = 1.0
    x_wide = x_wide[:, :wide_dim]
    y2 = np.eye(2, dtype=np.float32)[y]
    return x_deep, x_wide, y2


def load_movielens(path, num_negatives=4, seed=0):
    """MovieLens implicit-feedback training triples from ``path``.

    Accepts ``ratings.csv`` (ml-20m/25m: header, comma-separated
    userId,movieId,rating,timestamp) or ``ratings.dat`` (ml-1m:
    ``::``-separated, no header).  Reference movielens.py semantics:
    ratings > 0 are positives, items are densely re-indexed in first-seen
    order, each user's LATEST rating is held out for testing, and
    ``num_negatives`` unseen items are sampled per positive.

    Returns ``(users [M] i32, items [M] i32, labels [M] f32,
    num_users, num_items)``.
    """
    csvf = os.path.join(path, "ratings.csv")
    datf = os.path.join(path, "ratings.dat")
    if os.path.exists(csvf):
        lines = open(csvf).read().splitlines()[1:]
        rows = [ln.split(",") for ln in lines if ln]
    elif os.path.exists(datf):
        rows = [ln.split("::") for ln in
                open(datf).read().splitlines() if ln]
    else:
        raise FileNotFoundError(
            f"no ratings.csv / ratings.dat under {path!r}")
    item_map = {}
    seen = {}
    latest = {}
    triples = []
    for parts in rows:
        u = int(parts[0]) - 1
        raw_item = int(parts[1])
        if raw_item not in item_map:
            item_map[raw_item] = len(item_map)
        if float(parts[2]) <= 0:
            continue
        it = item_map[raw_item]
        ts = float(parts[3]) if len(parts) > 3 else 0.0
        triples.append((u, it))
        seen.setdefault(u, set()).add(it)
        if ts >= latest.get(u, (-1.0, None))[0]:
            latest[u] = (ts, it)
    num_users = max(t[0] for t in triples) + 1
    num_items = len(item_map)
    rng = np.random.RandomState(seed)
    users, items, labels = [], [], []
    for u, it in triples:
        if latest.get(u, (None, None))[1] == it:
            continue                    # held out for eval
        users.append(u)
        items.append(it)
        labels.append(1.0)
        if len(seen[u]) >= num_items:
            continue                    # user saw everything: no negative
        for _ in range(num_negatives):
            j = rng.randint(num_items)
            tries = 0
            while j in seen[u] and tries < 100:
                j = rng.randint(num_items)
                tries += 1
            if j in seen[u]:
                continue                # dense user: skip this negative
            users.append(u)
            items.append(j)
            labels.append(0.0)
    return (np.asarray(users, np.int32), np.asarray(items, np.int32),
            np.asarray(labels, np.float32), num_users, num_items)
