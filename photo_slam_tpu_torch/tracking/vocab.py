"""Bag-of-binary-words place recognition — the DBoW2 role.

photo_slam_tpu/tracking/vocab.py, copied (numpy only, on the host):
BinaryVocab.train keeps RandomState(seed), so both packages train the same
vocabulary from the same descriptors.

The reference recognizes revisits with a DBoW2 vocabulary tree + inverted
index (reference: ORB-SLAM3/Thirdparty/DBoW2, used by
ORB-SLAM3/src/LoopClosing.cc DetectLoop and KeyFrameDatabase.cc
DetectLoopCandidates). Shipping DBoW2's pre-trained 1M-word ORB vocabulary is
neither possible (no egress) nor necessary at SLAM scale: a run holds a few
hundred keyframes, so a SMALL vocabulary trained online from the run's own
descriptors is more discriminative in-domain than a giant generic one.

Design:
  * BinaryVocab — k-means over packed 256-bit ORB descriptors with Hamming
    assignment and majority-bit centroid updates (the textbook binary
    k-means; DBoW2's tree is hierarchical k-means of the same kind).
  * KeyframeDatabase — per-keyframe TF-IDF weighted word histograms and the
    DBoW2 L1 similarity score s(a,b) = 1 - 0.5*|a/|a| - b/|b||_1.
    Keyframes are scored in ONE vectorized matrix pass (an inverted index
    buys nothing at a few hundred documents).
  * The vocabulary trains lazily once enough descriptors accumulate;
    until then queries return nothing (loops cannot happen within the first
    handful of keyframes anyway) and every added keyframe is kept to be
    back-filled into the index on training.

The caller (SlamFrontend._detect_loop) mirrors ORB-SLAM3's candidate gating:
a candidate must score at least as high as the query's WORST covisible
neighbor (LoopClosing::DetectLoop's minScore) — the normalization that keeps
repetitive texture from producing false loops.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

def _pm1(desc: np.ndarray) -> np.ndarray:
    """Packed uint8 rows -> float32 {-1,+1} bit matrix [N, 256]."""
    bits = np.unpackbits(np.asarray(desc, np.uint8), axis=1)
    return bits.astype(np.float32) * 2.0 - 1.0


def _hamming_pm1(a_pm1: np.ndarray, b_pm1: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distances from +-1 bit matrices via ONE matmul:
    ham = (nbits - <a, b>)/2. BLAS makes this ~100x faster than xor+popcount
    table lookups for the [20k, 256] x [256, 256] training assignments."""
    nbits = a_pm1.shape[1]
    return (nbits - a_pm1 @ b_pm1.T) * 0.5


class BinaryVocab:
    """k-word binary vocabulary over packed 256-bit descriptors."""

    def __init__(self, words: np.ndarray):
        self.words = np.ascontiguousarray(words, np.uint8)  # [K, 32]
        self.k = len(words)
        self._words_pm1 = _pm1(self.words)

    @staticmethod
    def train(desc: np.ndarray, k: int = 256, iters: int = 6,
              seed: int = 0) -> "BinaryVocab":
        """Binary k-means: Hamming assignment, majority-bit update."""
        desc = np.asarray(desc, np.uint8)
        rng = np.random.RandomState(seed)
        m = len(desc)
        k = min(k, m)
        centers = desc[rng.choice(m, k, replace=False)].copy()
        bits = np.unpackbits(desc, axis=1).astype(np.float32)  # [M, 256]
        bits_pm1 = bits * 2.0 - 1.0
        assign = None
        for _ in range(iters):
            d = _hamming_pm1(bits_pm1, _pm1(centers))  # [M, K]
            new_assign = d.argmin(axis=1)
            if assign is not None and np.array_equal(new_assign, assign):
                break
            assign = new_assign
            for j in range(k):
                sel = assign == j
                if sel.any():
                    centers[j] = np.packbits(bits[sel].mean(0) >= 0.5)
                else:  # re-seed empty cluster with the farthest descriptor
                    far = d[np.arange(m), assign].argmax()
                    centers[j] = desc[far]
        return BinaryVocab(centers)

    def assign(self, desc: np.ndarray) -> np.ndarray:
        """Word id per descriptor ([N] int32)."""
        if len(desc) == 0:
            return np.zeros(0, np.int32)
        return _hamming_pm1(_pm1(desc), self._words_pm1).argmin(
            axis=1).astype(np.int32)

    def tf(self, desc: np.ndarray) -> np.ndarray:
        """Raw word-count histogram [K] float32."""
        return np.bincount(self.assign(desc),
                           minlength=self.k).astype(np.float32)


class KeyframeDatabase:
    """TF-IDF keyframe retrieval (the DBoW2 KeyFrameDatabase role)."""

    def __init__(self, vocab_k: int = 256, train_min_desc: int = 2400,
                 train_min_kfs: int = 6, max_desc_per_kf: int = 300,
                 seed: int = 0):
        self.vocab: Optional[BinaryVocab] = None
        self.vocab_k = vocab_k
        self.train_min_desc = train_min_desc
        self.train_min_kfs = train_min_kfs
        self.max_desc_per_kf = max_desc_per_kf
        self.seed = seed
        self._tf: dict[int, np.ndarray] = {}       # kfid -> [K] counts
        self._pending: dict[int, np.ndarray] = {}  # pre-training descriptors
        self._df: Optional[np.ndarray] = None      # [K] document frequency
        # score-matrix cache (rebuilt lazily after adds)
        self._ids: list[int] = []
        self._mat: Optional[np.ndarray] = None

    # -- indexing -------------------------------------------------------

    def add(self, kfid: int, desc: np.ndarray) -> None:
        desc = np.asarray(desc, np.uint8)[: self.max_desc_per_kf]
        if self.vocab is None:
            self._pending[kfid] = desc
            total = sum(len(d) for d in self._pending.values())
            if (len(self._pending) >= self.train_min_kfs
                    and total >= self.train_min_desc):
                self._train_and_backfill()
            return
        self._insert(kfid, self.vocab.tf(desc))

    def _train_and_backfill(self) -> None:
        pool = np.concatenate(list(self._pending.values()))
        if len(pool) > 12_000:  # bound the one-time training cost (~1s)
            rng = np.random.RandomState(self.seed)
            pool = pool[rng.choice(len(pool), 12_000, replace=False)]
        self.vocab = BinaryVocab.train(pool, k=self.vocab_k, seed=self.seed)
        self._df = np.zeros(self.vocab.k, np.float32)
        for kfid, desc in self._pending.items():
            self._insert(kfid, self.vocab.tf(desc))
        self._pending.clear()

    def _insert(self, kfid: int, tf: np.ndarray) -> None:
        self._tf[kfid] = tf
        self._df += tf > 0
        self._mat = None  # invalidate

    @property
    def trained(self) -> bool:
        return self.vocab is not None

    def __contains__(self, kfid: int) -> bool:
        return kfid in self._tf or kfid in self._pending

    # -- scoring --------------------------------------------------------

    def _weighted(self) -> tuple[list[int], np.ndarray, np.ndarray]:
        """(ids, idf [K], L1-normalized tf-idf matrix [N,K])."""
        if self._mat is None:
            n = max(len(self._tf), 1)
            idf = np.log(n / (1.0 + self._df)) + 1.0
            idf = np.maximum(idf, 0.0).astype(np.float32)
            self._ids = sorted(self._tf)
            mat = np.stack([self._tf[k] for k in self._ids]) * idf
            mat /= np.maximum(mat.sum(1, keepdims=True), 1e-9)
            self._idf = idf
            self._mat = mat
        return self._ids, self._idf, self._mat

    def _vec(self, desc_or_kfid) -> Optional[np.ndarray]:
        ids, idf, mat = self._weighted()
        if isinstance(desc_or_kfid, (int, np.integer)):
            if desc_or_kfid not in self._tf:
                return None
            v = self._tf[desc_or_kfid] * idf
        else:
            v = self.vocab.tf(np.asarray(desc_or_kfid,
                                         np.uint8)[: self.max_desc_per_kf])
            v = v * idf
        s = v.sum()
        return v / s if s > 0 else None

    def query(self, desc_or_kfid, exclude=(), topk: int = 8):
        """Top-k (kfid, score) by the DBoW2 L1 score, best first."""
        if self.vocab is None:
            return []
        v = self._vec(desc_or_kfid)
        if v is None:
            return []
        ids, _, mat = self._weighted()
        # s = 1 - 0.5 * |a - b|_1 for L1-normalized vectors.
        scores = 1.0 - 0.5 * np.abs(mat - v[None]).sum(axis=1)
        exclude = set(exclude)
        if isinstance(desc_or_kfid, (int, np.integer)):
            exclude.add(int(desc_or_kfid))
        order = np.argsort(-scores)
        out = []
        for j in order:
            kfid = ids[int(j)]
            if kfid in exclude:
                continue
            out.append((kfid, float(scores[j])))
            if len(out) >= topk:
                break
        return out

    def score(self, a: int, b: int) -> float:
        """Similarity of two indexed keyframes (0 if either is missing)."""
        if self.vocab is None:
            return 0.0
        va, vb = self._vec(a), self._vec(b)
        if va is None or vb is None:
            return 0.0
        return float(1.0 - 0.5 * np.abs(va - vb).sum())
