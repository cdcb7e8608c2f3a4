"""Error-distribution scatter plots (counterpart of
deeppicarditeration_tpu/evaluation/plots.py).

Two panels per figure: |u - u_exact| against t and against |x| (the x
magnitude when nx > 1), saved as ``{name}_error_distribution.png`` in the
experiment directory. matplotlib is imported inside ``plot_error``: the
card's machine has none, and nothing else here needs it.
"""

from __future__ import annotations

import pathlib

import numpy as np


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def plot_error(exp_dir, t, x, error, name: str):
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    t = _host(t).reshape(-1)
    x = _host(x)
    error = _host(error).reshape(-1)
    fig, axs = plt.subplots(2, 1, figsize=(8, 6))
    axs[0].scatter(t, error, s=4)
    axs[0].set_title(r"t vs $|u(t,x) - u_{exact}(t,x)|$")
    axs[0].set_xlabel("t")
    axs[0].set_ylabel("error")

    x_text = "x"
    if x.ndim == 2 and x.shape[1] > 1:
        x = np.linalg.norm(x, axis=-1)
        x_text = "|x|"
    axs[1].scatter(x.reshape(-1), error, s=4)
    axs[1].set_title(r"%s vs $|u(t,x) - u_{exact}(t,x)|$" % x_text)
    axs[1].set_xlabel(x_text)
    axs[1].set_ylabel("error")

    plt.tight_layout()
    fig_path = pathlib.Path(exp_dir) / f"{name}_error_distribution.png"
    plt.savefig(fig_path)
    plt.close(fig)
    return fig_path
