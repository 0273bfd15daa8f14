"""Synthetic click-log batches for DIN (seeded by step — replayable)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def din_batch(batch: int, seq_len: int, n_items: int, n_cates: int,
              n_user_feats: int, user_feat_vocab: int, step: int = 0,
              seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, step))
    hist_len = rng.integers(1, seq_len + 1, size=batch)
    mask = (np.arange(seq_len)[None, :] < hist_len[:, None])
    hist_items = rng.integers(0, n_items, (batch, seq_len)).astype(np.int32)
    item_id = rng.integers(0, n_items, batch).astype(np.int32)
    # learnable signal: click iff target shares category with recent history
    cate_of = lambda items: (np.asarray(items, np.uint64) * np.uint64(2654435761)
                             % np.uint64(n_cates)).astype(np.int32)
    hist_cates = cate_of(hist_items)
    cate_id = cate_of(item_id)
    overlap = (hist_cates == cate_id[:, None]) & mask
    label = (overlap.sum(1) > 0).astype(np.float32)
    # inject noise
    flip = rng.random(batch) < 0.1
    label = np.where(flip, 1 - label, label)
    return {
        "item_id": item_id, "cate_id": cate_id,
        "hist_items": np.where(mask, hist_items, 0).astype(np.int32),
        "hist_cates": np.where(mask, hist_cates, 0).astype(np.int32),
        "hist_mask": mask.astype(np.float32),
        "user_feats": rng.integers(0, user_feat_vocab,
                                   (batch, n_user_feats)).astype(np.int32),
        "label": label,
    }


def retrieval_batch(seq_len: int, n_items: int, n_cates: int,
                    n_user_feats: int, user_feat_vocab: int,
                    n_candidates: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    base = din_batch(1, seq_len, n_items, n_cates, n_user_feats,
                     user_feat_vocab, step=0, seed=seed)
    cand = rng.integers(0, n_items, n_candidates).astype(np.int32)
    return {
        "hist_items": base["hist_items"], "hist_cates": base["hist_cates"],
        "hist_mask": base["hist_mask"], "user_feats": base["user_feats"],
        "cand_items": cand,
        "cand_cates": (np.asarray(cand, np.uint64) * np.uint64(2654435761)
                       % np.uint64(n_cates)).astype(np.int32),
    }
