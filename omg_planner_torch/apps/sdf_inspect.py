"""SDF volume inspector CLI (counterpart of
``omg_planner_tpu/apps/sdf_inspect.py``; reference
``omg/sdf_tools.py:201-246``).

Run:  ``python -m omg_planner_torch.apps.sdf_inspect -f vol.pkl [-v out.png]
[-e out.pkl]``

Loads ``.sdf`` (SDFGen text), ``.pth`` (reference torch layout) or ``.pkl``
volumes, prints the same info line as the reference inspector, optionally
renders a slice montage (``-v``, matplotlib PNG instead of the reference's
mayavi window) and re-exports (``-e``).  Host-side only: matplotlib is
imported only under ``-v``.
"""

from __future__ import annotations

import argparse

import numpy as np


def load_any(path: str):
    from ..ops.sdf import SignedDensityField

    if path.endswith(".sdf"):
        return SignedDensityField.from_sdf_file(path)
    if path.endswith(".pth"):
        return SignedDensityField.from_pth(path)
    return SignedDensityField.from_pkl(path)


def slice_montage(sdf, out_png: str, n: int = 6):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.asarray(sdf.data)
    zs = np.linspace(0, data.shape[2] - 1, n).astype(int)
    fig, axes = plt.subplots(1, n, figsize=(2.2 * n, 2.4))
    lim = float(np.abs(data).max()) or 1.0
    for ax, z in zip(axes, zs):
        ax.imshow(data[:, :, z].T, cmap="RdBu", vmin=-lim, vmax=lim,
                  origin="lower")
        ax.set_title(f"z={z}", fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file", required=True)
    ap.add_argument("-v", "--vis", metavar="PNG", default=None,
                    help="write a z-slice montage image")
    ap.add_argument("-e", "--export", default=None,
                    help="re-export to a .pkl volume")
    args = ap.parse_args(argv)

    sdf = load_any(args.file)
    data = np.asarray(sdf.data)
    # same fields as the reference's info print (sdf_tools.py:229-236)
    print("sdf info:", float(sdf.delta), tuple(data.shape),
          np.asarray(sdf.origin).tolist(), int((data > 0.01).sum()),
          (float(sdf.delta) * np.array(data.shape)).tolist())
    if args.vis:
        slice_montage(sdf, args.vis)
        print(f"wrote {args.vis}")
    if args.export:
        sdf.dump(args.export)
        print(f"wrote {args.export}")


if __name__ == "__main__":
    main()
