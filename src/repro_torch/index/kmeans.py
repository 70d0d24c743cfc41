"""Spherical k-means over unit vectors (sem_group_by clustering stage and
the IVF coarse quantizer: `repro_torch.index.ivf_index`)."""
from __future__ import annotations

import numpy as np


def kmeans(vectors: np.ndarray, k: int, *, iters: int = 25, seed: int = 0
           ) -> tuple[np.ndarray, np.ndarray]:
    """-> (centers [k, d] unit vectors, assignment [n])."""
    x = np.asarray(vectors, np.float32)
    n = len(x)
    k = min(k, n)
    rng = np.random.default_rng(seed)

    # k-means++ style init on cosine distance.  ``best`` is each point's
    # highest similarity to the centres chosen so far, raised as each centre
    # lands: the reference recomputes it from every centre for every new
    # one (O(k^2 n d)); a max is exact, so the draws are the same
    centers = [x[rng.integers(n)]]
    best = x @ centers[0]
    for _ in range(1, k):
        d = 1.0 - best
        d = np.clip(d, 1e-9, None) ** 2
        centers.append(x[rng.choice(n, p=d / d.sum())])
        best = np.maximum(best, x @ centers[-1])
    c = np.stack(centers)

    assign = np.full(n, -1, np.int64)  # sentinel: nothing assigned yet
    for it in range(iters):
        sims = x @ c.T
        new_assign = np.argmax(sims, axis=1)
        if it > 0 and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        reseeded: set[int] = set()
        for j in range(k):
            m = assign == j
            if m.any():
                v = x[m].mean(axis=0)
                c[j] = v / max(np.linalg.norm(v), 1e-9)
            else:  # re-seed empty cluster at the worst-assigned point
                worst_order = np.argsort(np.max(x @ c.T, axis=1))
                # two empty clusters in one sweep must not grab the same point
                pick = next((int(w) for w in worst_order if int(w) not in reseeded),
                            int(worst_order[0]))
                reseeded.add(pick)
                c[j] = x[pick]
    return c, assign
