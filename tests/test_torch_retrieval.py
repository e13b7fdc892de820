"""The port's retrieval (`slam/retrieval.py`) against the JAX package's.

* The feature head: `prep_features` on the same weights (the JAX init
  carried over with `retrieval_params_from_numpy`) and the same encoder
  features agrees within 1e-5 of each output's scale, selects the same
  tokens in the same order, and keeps the lower index first on tied
  attention, as `lax.top_k` does.
* The host ASMK half on identical features: the same `update` results,
  scores and database state, with a given codebook, through the k-means
  bootstrap phase, and with `use_idf` (the cases of
  tests/test_retrieval.py:24-130,238); the same k-means codebook and
  packed binary codes.
"""

import jax
import numpy as np
import pytest
import torch

from monst3r_slam_tpu.slam import retrieval as jr
from monst3r_slam_torch.slam import retrieval as tr


def _params(dim=64, hdims=(32,), residual=False):
    jp = jr.init_retrieval_params(jax.random.PRNGKey(0), dim, hdims=hdims, residual=residual)
    jp = jax.tree.map(np.asarray, jp)
    return jp, tr.retrieval_params_from_numpy(jp)


@pytest.mark.parametrize("hdims,residual", [((32,), False), ((48, 32), False), ((64,), True)])
def test_prep_features_matches_jax(hdims, residual):
    jp, tp = _params(hdims=hdims, residual=residual)
    # a non-zero whitening, so both whiteners do real work
    rng = np.random.default_rng(1)
    for key in ("prewhiten", "postwhiten"):
        d = jp[key]["m"].shape[0]
        jp[key]["m"] = rng.normal(size=d).astype(np.float32) * 0.1
        jp[key]["p"] = (np.eye(d) + 0.05 * rng.normal(size=(d, d))).astype(np.float32)
    tp = tr.retrieval_params_from_numpy(jp)
    feat = rng.standard_normal((2, 100, 64)).astype(np.float32)
    j = np.asarray(jr.prep_features(jp, feat, nfeat=30))
    t = tr.prep_features(tp, torch.from_numpy(feat), nfeat=30).numpy()
    assert t.shape == j.shape == (2, 30, hdims[-1])
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())


def test_top_k_ties_keep_the_lower_index_first():
    att = np.random.default_rng(2).integers(0, 4, (3, 50)).astype(np.float32)  # many ties
    want = np.asarray(jax.lax.top_k(att, 20)[1])
    np.testing.assert_array_equal(tr.top_k_indices(torch.from_numpy(att), 20).numpy(), want)


def test_binarize_and_kmeans_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    np.testing.assert_array_equal(tr.binarize_and_pack(x), jr.binarize_and_pack(x))
    p = tr.binarize_and_pack(x)
    np.testing.assert_array_equal(tr.hamming_sim_packed(p[0], p, 64),
                                  jr.hamming_sim_packed(p[0], p, 64))
    np.testing.assert_array_equal(tr.kmeans_codebook(x, 8), jr.kmeans_codebook(x, 8))
    np.testing.assert_array_equal(tr.kmeans_codebook(x[:5], 8), jr.kmeans_codebook(x[:5], 8))


def _drive(make, feats, queries):
    db = make()
    out = [db.update(f, True, k=3, min_thresh=m) for f, m in feats]
    out += [db.update(q, False, k=2, min_thresh=-1.0) for q in queries]
    scores = db.query(queries[0]) if db.centroids is not None else None
    return db, out, scores


@pytest.mark.parametrize("case", ["codebook", "bootstrap", "bootstrap_idf"])
def test_asmk_updates_match_jax(case):
    rng = np.random.default_rng(3)
    dim = 32
    bases = [rng.standard_normal((50, dim)).astype(np.float32) + 2.0 * rng.standard_normal(dim)
             for _ in range(4)]

    def view(b):
        return (b + 0.05 * rng.standard_normal(b.shape)).astype(np.float32)

    feats = [(view(bases[i % 4]), 0.0 if i % 2 else 1e-3) for i in range(7)]
    queries = [view(b) for b in bases]
    if case == "codebook":
        cents = rng.standard_normal((64, dim)).astype(np.float32)
        makes = (lambda: jr.ASMKDatabase(cents), lambda: tr.ASMKDatabase(cents))
    else:
        cfg = {"retrieval": {"n_words": 32, "bootstrap_frames": 3,
                             "use_idf": case == "bootstrap_idf"}}
        makes = (lambda: jr.ASMKDatabase.from_config(cfg),
                 lambda: tr.ASMKDatabase.from_config(cfg))
    (jdb, jout, js), (tdb, tout, ts) = (_drive(m, feats, queries) for m in makes)
    assert tout == jout
    assert any(tout[3:]), "nothing was ever retrieved"
    if case != "codebook":
        assert tout[:3] == [[], [], []]  # the bootstrap phase retrieves nothing
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tdb.centroids, jdb.centroids)
    assert tdb.kf_counter == jdb.kf_counter == 7
    np.testing.assert_array_equal(tdb.counts, jdb.counts)
    np.testing.assert_array_equal(tdb.norm_factor, jdb.norm_factor)


def test_from_config_and_codebook_pickle_match_jax(tmp_path):
    cfg = {"retrieval": {"n_words": 2048, "bootstrap_frames": 9, "use_idf": True}}
    for c in (cfg, {}):
        j, t = jr.ASMKDatabase.from_config(c), tr.ASMKDatabase.from_config(c)
        assert (t.n_words, t.bootstrap_frames, t.use_idf, t.centroids) == \
            (j.n_words, j.bootstrap_frames, j.use_idf, j.centroids)
    import pickle

    cents = np.random.default_rng(5).standard_normal((16, 8)).astype(np.float32)
    with open(tmp_path / "cb.pkl", "wb") as f:
        pickle.dump({"params": {"k": 16}, "state": {"centroids": cents}}, f)
    np.testing.assert_array_equal(tr.load_codebook(str(tmp_path / "cb.pkl")),
                                  jr.load_codebook(str(tmp_path / "cb.pkl")))


def _write_retrieval_checkpoint(path, d=64, hdims="48_32", nfeat=50):
    """A reference-format retrieval checkpoint with random weights: the
    whitening, a projector of one hidden Linear + LayerNorm and the output
    Linear, a backbone entry the converters skip, and the argparse args."""
    import argparse

    rng = np.random.default_rng(6)
    h, o = (int(x) for x in hdims.split("_"))

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    model = {
        "backbone.x": t(3), "prewhiten.m": t(1, d), "prewhiten.p": t(d, d),
        "projector.0.weight": t(h, d), "projector.0.bias": t(h),
        "projector.1.weight": t(h), "projector.1.bias": t(h),
        "projector.3.weight": t(o, h), "projector.3.bias": t(o),
        "postwhiten.m": t(1, o), "postwhiten.p": t(o, o),
    }
    torch.save({"model": model, "args": argparse.Namespace(hdims=hdims, nfeat=nfeat,
                                                           residual=False)}, path)


def test_retrieval_params_from_checkpoint_dim_matches_jax(tmp_path):
    """`retrieval_params_from_checkpoint(path, dim=)` takes the reference's
    `dim` and, as the reference, reads the widths from the file: every leaf
    equal to JAX's conversion, and to its own without `dim`."""
    path = str(tmp_path / "retrieval.pth")
    _write_retrieval_checkpoint(path)
    jp, jn = jr.retrieval_params_from_checkpoint(path, dim=64)
    tp, tn = tr.retrieval_params_from_checkpoint(path, dim=64)
    tp0, _ = tr.retrieval_params_from_checkpoint(path)
    assert tn == jn == 50

    def same(t, j):
        if isinstance(t, dict):
            assert t.keys() == j.keys()
            return all(same(t[k], j[k]) for k in t)
        if isinstance(t, list):
            return len(t) == len(j) and all(same(a, b) for a, b in zip(t, j))
        if isinstance(t, torch.Tensor):
            return np.array_equal(t.numpy(), np.asarray(j))
        return t == bool(j)

    assert same(tp, jp) and same(tp0, jax.tree.map(np.asarray, jp))
    assert len(tp["projector"]["hidden"]) == 1


def test_make_random_codebook_is_seeded():
    """Shape, dtype and one draw per seed (its bits differ from JAX's, which
    draws from a JAX key)."""
    def draw(seed):
        return tr.make_random_codebook(128, 32, generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == (128, 32) and a.dtype == np.float32 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert tr.make_random_codebook(4, 8).shape == (4, 8)
