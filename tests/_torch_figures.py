"""Figure data for the port's figure tests (``tests/test_torch_viz.py``,
``tests/test_torch_explain.py``): the data in a matplotlib figure's artists,
a comparison of two such records at a relative tolerance, and a capture of
every figure a plots module finishes."""

import contextlib
import os

import numpy as np


def artists(fig):
    """Per axes: title, axis labels and scales, limits, line data, scatter
    offsets, filled polygons, images, bars, texts with their positions, tick
    and legend labels."""
    from matplotlib.collections import PathCollection, PolyCollection
    from matplotlib.patches import Rectangle

    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "scales": (ax.get_xscale(), ax.get_yscale()),
            "lim": np.array([ax.get_xlim(), ax.get_ylim()]),
            "lines": [ln.get_xydata() for ln in ax.lines],
            "offsets": [np.asarray(c.get_offsets()) for c in ax.collections
                        if isinstance(c, PathCollection)],
            "polys": [np.concatenate([p.vertices for p in c.get_paths()])
                      for c in ax.collections if isinstance(c, PolyCollection)],
            "images": [np.asarray(im.get_array()) for im in ax.images],
            "bars": [np.array([p.get_x(), p.get_y(), p.get_width(), p.get_height()])
                     for p in ax.patches if isinstance(p, Rectangle)],
            "texts": [t.get_text() for t in ax.texts],
            "text_xy": [np.array(t.get_position(), float) for t in ax.texts],
            "ticks": ([t.get_text() for t in ax.get_xticklabels()],
                      [t.get_text() for t in ax.get_yticklabels()]),
            "legend": [t.get_text() for t in legend.get_texts()] if legend else None,
        })
    return out


def same(got, want, rtol, path="figure"):
    """Two ``artists`` records: arrays at ``rtol`` (NaN where NaN), all else
    equal."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            same(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{path}: {len(got)} against {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        g = np.ma.filled(np.ma.asarray(got, float), np.nan)
        w = np.ma.filled(np.ma.asarray(want, float), np.nan)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, equal_nan=True, err_msg=path)
    else:
        assert got == want, f"{path}: {got!r} against {want!r}"


@contextlib.contextmanager
def captured(monkeypatch, module, save=True):
    """{file name: artist data} of every figure ``module`` finishes; with
    ``save`` False the figure is closed unsaved."""
    seen = {}
    orig = module._finish

    def finish(fig, save_path):
        seen[os.path.basename(save_path)] = artists(fig)
        if save:
            return orig(fig, save_path)
        import matplotlib.pyplot as plt

        plt.close(fig)
        return save_path

    monkeypatch.setattr(module, "_finish", finish)
    try:
        yield seen
    finally:
        monkeypatch.setattr(module, "_finish", orig)
