"""Embedding visualization: t-SNE scatter of sampled item vectors, colored
by an optional label.

Counterpart of ``recsys_tpu/eval/viz.py``; scikit-learn and matplotlib are
imported inside the function, as there.
"""

from __future__ import annotations

import numpy as np


def tsne_scatter(embeddings: np.ndarray, out_path: str, labels=None,
                 sample: int = 1000, seed: int = 0, perplexity: float = 30.0):
    """Project up to ``sample`` embeddings to 2-D with t-SNE and save a PNG.
    Returns the 2-D coordinates."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    rng = np.random.default_rng(seed)
    n = min(sample, len(embeddings))
    idx = rng.choice(len(embeddings), n, replace=False)
    sub = np.asarray(embeddings)[idx]
    coords = TSNE(n_components=2, random_state=seed,
                  perplexity=min(perplexity, max(n // 4, 2)),
                  init="pca").fit_transform(sub)
    fig, ax = plt.subplots(figsize=(8, 8))
    if labels is not None:
        lab = np.asarray(labels)[idx]
        for value in np.unique(lab):
            m = lab == value
            ax.scatter(coords[m, 0], coords[m, 1], s=6, alpha=0.6, label=str(value))
        if len(np.unique(lab)) <= 12:
            ax.legend(markerscale=2, fontsize=8)
    else:
        ax.scatter(coords[:, 0], coords[:, 1], s=6, alpha=0.6)
    ax.set_title(f"item embeddings t-SNE (n={n})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return coords
