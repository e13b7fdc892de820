"""Loop-closure retrieval: HOW/ASMK over projected encoder features.

The port of the JAX package's `slam/retrieval.py`, in two halves:
  * the feature head (`mast3r/retrieval/model.py:55-160`: whitener,
    projector, l2-norm attention, top-k local selection) in torch, run on
    the card right after the encoder on the cached frame features;
  * ASMK with binarized descriptors and the incremental query-then-add
    inverted file of `mast3r_slam/retrieval_database.py:9-166`, host numpy,
    as the reference keeps it off the GPU; the port's own copy.

Default parameters follow `mast3r/retrieval/processor.py:91-99`: binary
kernel, multiple assignment 1 (build) / 5 (query), similarity alpha 3.0,
threshold 0.0, no idf. `retrieval_params_from_numpy` takes the JAX
package's parameter tree with numpy leaves, so both packages can run one
set of weights.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Feature head (device)
# ---------------------------------------------------------------------------


def whiten(p, x: torch.Tensor) -> torch.Tensor:
    """Whitener (retrieval/model.py:55-79): center, project, optional l2norm."""
    y = (x - p["m"]) @ p["p"]
    if p.get("l2norm", False):
        y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
    return y


def projector(p, x: torch.Tensor) -> torch.Tensor:
    """MLP projector (retrieval/model.py:144-157): (Linear, LN, GELU)* Linear;
    population variance and the exact (erf) GELU."""
    for layer in p["hidden"]:
        x = x @ layer["w"] + layer["b"]
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        x = (x - mu) * torch.rsqrt(var + 1e-5)
        x = F.gelu(x * layer["ln_w"] + layer["ln_b"], approximate="none")
    return x @ p["out"]["w"] + p["out"]["b"]


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, largest first and
    the lower index first among equal values, as `lax.top_k` orders them
    (`torch.topk` promises no order on ties): a stable descending sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


@torch.no_grad()
def prep_features(params, backbone_feat: torch.Tensor, nfeat: int = 300) -> torch.Tensor:
    """Encoder features (B, N, D) -> the top-`nfeat` whitened local features
    by attention (RetrievalDatabase.prep_features, retrieval_database.py:25-41):
    prewhiten -> projector (+residual) -> l2-norm attention -> postwhiten."""
    x = whiten(params["prewhiten"], backbone_feat.float())
    proj = projector(params["projector"], x)
    if params.get("residual", False):
        proj = proj + x
    attention = torch.linalg.vector_norm(proj, dim=-1)
    white = whiten(params["postwhiten"], proj)
    k = min(nfeat, white.shape[1])
    top_idx = top_k_indices(attention, k)
    return torch.gather(white, 1, top_idx[..., None].expand(-1, -1, white.shape[-1]))


def init_retrieval_params(gen: torch.Generator, dim: int, hdims=(1024,), residual: bool = False,
                          device=None):
    """Random feature-head weights from `gen` (tests, untrained runs)."""
    dev = device if device is not None else gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dev)

    hidden = []
    d = dim
    for h in hdims[:-1]:
        hidden.append({"w": normal(d, h) / np.sqrt(d), "b": torch.zeros(h, device=dev),
                       "ln_w": torch.ones(h, device=dev), "ln_b": torch.zeros(h, device=dev)})
        d = h
    out_dim = hdims[-1] if hdims else dim
    return {
        "prewhiten": {"m": torch.zeros(dim, device=dev), "p": torch.eye(dim, device=dev)},
        "projector": {"hidden": hidden,
                      "out": {"w": normal(d, out_dim) / np.sqrt(d),
                              "b": torch.zeros(out_dim, device=dev)}},
        "postwhiten": {"m": torch.zeros(out_dim, device=dev), "p": torch.eye(out_dim, device=dev)},
        "residual": residual,
    }


def retrieval_params_from_numpy(tree, device="cpu"):
    """A feature-head tree with numpy (or array-like) leaves, in the JAX
    package's layout (the same as this module's), -> torch on `device`."""
    if isinstance(tree, dict):
        return {k: retrieval_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [retrieval_params_from_numpy(v, device) for v in tree]
    if isinstance(tree, (bool, np.bool_)):
        return bool(tree)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def retrieval_params_from_checkpoint(path: str, dim: int = 1024, device="cpu"):
    """The reference retrieval checkpoint
    (`MASt3R_..._retrieval_trainingfree.pth`) -> (feature-head params, nfeat).
    The widths come from the checkpoint; `dim` is accepted, and unused, as
    in the reference. The file is unpickled in full: load only trusted
    checkpoints."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() for k, v in ckpt["model"].items() if not k.startswith("backbone")}
    args = ckpt["args"]
    hdims = list(map(int, args.hdims.split("_"))) if len(args.hdims) > 0 else []
    # the torch projector is an nn.Sequential: Linear, LayerNorm, GELU, ..., Linear
    n_hidden = max(0, len(hdims) - 1)
    hidden = [{
        "w": sd[f"projector.{3 * i}.weight"].T, "b": sd[f"projector.{3 * i}.bias"],
        "ln_w": sd[f"projector.{3 * i + 1}.weight"], "ln_b": sd[f"projector.{3 * i + 1}.bias"],
    } for i in range(n_hidden)]
    params = {
        "prewhiten": {"m": sd["prewhiten.m"].reshape(-1), "p": sd["prewhiten.p"]},
        "projector": {"hidden": hidden,
                      "out": {"w": sd[f"projector.{3 * n_hidden}.weight"].T,
                              "b": sd[f"projector.{3 * n_hidden}.bias"]}},
        "postwhiten": {"m": sd["postwhiten.m"].reshape(-1), "p": sd["postwhiten.p"]},
        "residual": bool(getattr(args, "residual", False)),
    }
    return retrieval_params_from_numpy(params, device), int(args.nfeat)


# ---------------------------------------------------------------------------
# ASMK (host, numpy)
# ---------------------------------------------------------------------------

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def binarize_and_pack(x: np.ndarray) -> np.ndarray:
    """Sign-binarize rows and pack to uint8 (hamming.pyx:15-28)."""
    return np.packbits((x > 0).astype(np.uint8), axis=-1)


def hamming_sim_packed(q: np.ndarray, db: np.ndarray, dim: int) -> np.ndarray:
    """Similarity in [-1, 1] from the normalized hamming distance
    (kernel.py:60-64: sim = 1 - 2 * hdist / dim)."""
    hdist = _POPCOUNT[np.bitwise_xor(q[None, :], db)].sum(axis=-1)
    return 1.0 - 2.0 * hdist / dim


class ASMKDatabase:
    """Incremental binary-ASMK inverted file, query-then-add per keyframe.

    `update(feat, add_after_query, k, min_thresh)` returns the top-k matched
    keyframe indices above the threshold (RetrievalDatabase.update,
    retrieval_database.py:43-94).

    With `centroids=None` the codebook is bootstrapped: the features of the
    first `bootstrap_frames` keyframes are buffered, k-means fits the
    codebook on them, and the buffered frames are then indexed; until then
    nothing is retrieved. `use_idf` weights each visual word by its squared,
    smoothed log inverse document frequency, recomputed per query from the
    current counts.
    """

    def __init__(self, centroids: Optional[np.ndarray], alpha: float = 3.0,
                 similarity_threshold: float = 0.0, ma_build: int = 1, ma_query: int = 5,
                 n_words: int = 1024, dim: int = 64, bootstrap_frames: int = 5,
                 use_idf: bool = False):
        self.alpha = alpha
        self.similarity_threshold = similarity_threshold
        self.ma_build = ma_build
        self.ma_query = ma_query
        self.bootstrap_frames = bootstrap_frames
        self.use_idf = use_idf
        self._pending: List[np.ndarray] = []
        if centroids is not None:
            self._set_centroids(np.asarray(centroids, np.float32))
        else:
            self.centroids = None
            self.n_words, self.dim = n_words, dim
        self.norm_factor = np.zeros(0)
        self.kf_counter = 0

    @classmethod
    def from_config(cls, config: dict) -> "ASMKDatabase":
        """A bootstrap-mode database with the codebook policy of the run
        config (`retrieval.n_words`, `retrieval.bootstrap_frames`,
        `retrieval.use_idf`): the path without a pretrained codebook."""
        r = config.get("retrieval", {}) if config else {}
        return cls(None, n_words=int(r.get("n_words", 1024)),
                   bootstrap_frames=int(r.get("bootstrap_frames", 5)),
                   use_idf=bool(r.get("use_idf", False)))

    def _set_centroids(self, centroids: np.ndarray):
        self.centroids = np.asarray(centroids, np.float32)
        self.cent_sq = (self.centroids**2).sum(1)
        self.n_words, self.dim = self.centroids.shape
        self.ivf_vecs: List[Optional[np.ndarray]] = [None] * self.n_words
        self.ivf_imids: List[Optional[np.ndarray]] = [None] * self.n_words
        self.counts = np.zeros(self.n_words, np.int64)
        self.word_imgs = np.zeros(self.n_words, np.int64)  # images per word
        self.image_words: List[np.ndarray] = []  # words per image (idf norms)

    def quantize(self, vecs: np.ndarray, k: int) -> np.ndarray:
        """Top-k nearest centroids by L2 (retrieval_database.py:96-105)."""
        d2 = (vecs**2).sum(1)[:, None] + self.cent_sq[None, :] - 2.0 * vecs @ self.centroids.T
        if k == 1:
            return np.argmin(d2, axis=1)[:, None]
        idx = np.argpartition(d2, k, axis=1)[:, :k]
        row = np.arange(vecs.shape[0])[:, None]
        return idx[row, np.argsort(d2[row, idx], axis=1)]

    def _aggregate(self, vecs: np.ndarray, word_ids: np.ndarray):
        """Per-word residual aggregation and binarization (kernel.py:26-38)."""
        unique = np.unique(word_ids)
        ades = np.empty((unique.shape[0], self.dim), np.float32)
        for i, word in enumerate(unique):
            members = (word_ids == word).any(axis=1)
            ades[i] = (vecs[members] - self.centroids[word]).sum(0)
        return binarize_and_pack(ades), unique

    def _idf(self) -> np.ndarray:
        N = max(self.kf_counter, 1)
        return np.log((N + 1.0) / (self.word_imgs + 1.0)) ** 2

    def query(self, vecs: np.ndarray) -> np.ndarray:
        """Scores against every stored image (inverted_file.py:86-107)."""
        words = self.quantize(vecs, self.ma_query)
        agg, unique = self._aggregate(vecs, words)
        scores = np.zeros(self.kf_counter)
        if self.use_idf:
            idf = self._idf()
            norm_factor = np.asarray([max(idf[w].sum(), 1e-12) for w in self.image_words])
        else:
            idf = None
            norm_factor = self.norm_factor
        q_norm = 0.0
        for qvec, word in zip(agg, unique):
            w_weight = 1.0 if idf is None else float(idf[word])
            q_norm += w_weight
            if self.ivf_imids[word] is None or w_weight <= 0.0:
                continue
            n = self.counts[word]
            sim = hamming_sim_packed(qvec, self.ivf_vecs[word][:n], self.dim)
            imids = self.ivf_imids[word][:n]
            mask = sim >= self.similarity_threshold
            sim = w_weight * np.power(sim[mask], self.alpha)
            imids = imids[mask]
            sim /= np.sqrt(norm_factor[imids])
            np.add.at(scores, imids, sim)
        return scores / np.sqrt(max(q_norm, 1e-12))

    def add(self, vecs: np.ndarray):
        words = self.quantize(vecs, self.ma_build)
        agg, unique = self._aggregate(vecs, words)
        imid = self.kf_counter
        self.norm_factor = np.concatenate([self.norm_factor, np.zeros(1)])
        for vec, word in zip(agg, unique):
            n = self.counts[word]
            if self.ivf_vecs[word] is None:
                self.ivf_vecs[word] = np.zeros((10,) + vec.shape, vec.dtype)
                self.ivf_imids[word] = np.zeros(10, np.int64)
            elif n >= self.ivf_vecs[word].shape[0]:
                new = int(np.ceil(self.ivf_vecs[word].shape[0] * 1.5))
                self.ivf_vecs[word] = np.resize(self.ivf_vecs[word], (new,) + vec.shape)
                self.ivf_imids[word] = np.resize(self.ivf_imids[word], new)
            self.ivf_vecs[word][n] = vec
            self.ivf_imids[word][n] = imid
            self.counts[word] += 1
            self.norm_factor[imid] += 1.0
            self.word_imgs[word] += 1
        self.image_words.append(unique.copy())
        self.kf_counter += 1

    def update(self, feat: np.ndarray, add_after_query: bool, k: int, min_thresh: float = 0.0):
        """Query the top-k matches, then optionally insert."""
        if self.centroids is None:  # bootstrap phase: buffer, retrieve nothing
            feat = np.asarray(feat, np.float32).reshape(feat.shape[0], -1)
            if add_after_query:
                self._pending.append(feat)
                if len(self._pending) >= self.bootstrap_frames:
                    self._set_centroids(kmeans_codebook(np.concatenate(self._pending),
                                                        self.n_words))
                    pending, self._pending = self._pending, []
                    for f in pending:
                        self.add(f)
            return []
        feat = np.asarray(feat, np.float32).reshape(-1, self.centroids.shape[1])
        topk: List[int] = []
        if self.kf_counter > 0:
            scores = self.query(feat)
            order = np.argsort(-scores)[: min(k, self.kf_counter)]
            topk = [int(i) for i in order if scores[i] > min_thresh]
        if add_after_query:
            self.add(feat)
        return topk


def make_random_codebook(n_words: int, dim: int, generator: Optional[torch.Generator] = None
                         ) -> np.ndarray:
    """Untrained fallback codebook (n_words, dim) f32 of standard normals
    from `generator` (a fresh unseeded one by default). The reference draws
    from a JAX key, so the same seed gives other numbers here."""
    dev = None if generator is None else generator.device
    return torch.randn((n_words, dim), generator=generator, device=dev).cpu().numpy()


def kmeans_codebook(feats: np.ndarray, n_words: int, iters: int = 15, seed: int = 0) -> np.ndarray:
    """Plain-numpy Lloyd k-means for codebook bootstrapping, initialized
    from a random sample; a tiny input is padded with jittered copies."""
    feats = np.asarray(feats, np.float32)
    n, d = feats.shape
    rng = np.random.default_rng(seed)
    k = min(n_words, n)
    cent = feats[rng.choice(n, k, replace=False)].copy()
    for _ in range(iters):
        d2 = (feats**2).sum(1)[:, None] + (cent**2).sum(1)[None, :] - 2.0 * feats @ cent.T
        assign = np.argmin(d2, axis=1)
        for j in range(k):
            members = feats[assign == j]
            if len(members):
                cent[j] = members.mean(0)
            else:  # re-seed an empty cell on a random point
                cent[j] = feats[rng.integers(n)]
    if k < n_words:
        extra = cent[rng.integers(k, size=n_words - k)]
        extra = extra + 1e-3 * rng.standard_normal(extra.shape).astype(np.float32)
        cent = np.concatenate([cent, extra])
    return cent


def load_codebook(path: str) -> np.ndarray:
    """The reference codebook pickle (asmk cache format). Unpickling runs
    code: load only trusted files."""
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f)
    if isinstance(data, dict):
        for key in ("centroids", "codebook"):
            if key in data:
                data = data[key]
                break
        if isinstance(data, dict) and "state" in data:
            data = data["state"]["centroids"]
    return np.asarray(data, np.float32)
