"""Before and after of the plan kernels (``panda_fk``, ``sdf_query``) on one
card, in one call: this checkout against another (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).

    python3 scripts/plan_kernels_ab.py OTHER_CHECKOUT [OUT_DIR] [PAIRS]

Runs each checkout's own ``chip_smoke.py`` phase 3b (``phase_environment``
then ``phase_plan_kernels``: its kernels built from its own sources, its
wrappers, its checks) in a fresh process, in the order other, this, this,
other, ... (PAIRS pairs, default 2), each followed by the cold-start probe
of this checkout's ``chip_smoke.COLD_PROBE`` on that checkout's package.
Each run's output goes to OUT_DIR (default ``build/plan_kernels_ab``) as
``<i>-<side>.out``.  Prints, for every phase 3b shape and side, the
medians over the side's runs of the kernel's time (50 launches in one CUDA
graph), its share of the bound, the time through the wrapper (or the
vmap) and the wrapper's host time a call, then each side's cold first
calls and the modules they imported.
"""

import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PHASE = ("import chip_smoke as cs; cs.phase_environment(); "
         "cs.phase_plan_kernels('cuda')")
LINE = re.compile(
    r"^(panda_fk N=\d+|sdf_query \w+ B=\d+ P=\d+(?: \(vmap\))?): kernel "
    r"([\d.]+) ms \(graph of 50\), through the (?:wrapper|vmap) ([\d.]+) ms "
    r"a call.* bound ([\d.]+) ms .* wrapper host ([\d.]+) us a call")


def run_phase(root: str) -> tuple:
    """({shape: (graph ms, bound ms, wrapper ms, host us)}, output) of one
    run of ``root``'s phase 3b."""
    out = subprocess.run([sys.executable, "-c", PHASE], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"phase 3b of {root} failed:\n"
                           f"{out.stderr[-3000:]}")
    rows = {}
    for line in out.stdout.splitlines():
        m = LINE.match(line)
        if m:
            ms, wrapped, bound, host = map(float, m.groups()[1:])
            rows[m.group(1)] = (ms, bound, wrapped, host)
    return rows, out.stdout


def main() -> int:
    other = os.path.abspath(sys.argv[1])
    out_dir = (sys.argv[2] if len(sys.argv) > 2
               else os.path.join(ROOT, "build", "plan_kernels_ab"))
    pairs = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = []
    for p in range(pairs):
        order += ["other", "this"] if p % 2 == 0 else ["this", "other"]
    runs = {"other": [], "this": []}
    colds = {"other": [], "this": []}
    for i, side in enumerate(order, 1):
        root = other if side == "other" else ROOT
        rows, text = run_phase(root)
        cold = cs.cold_start(root)
        with open(os.path.join(out_dir, f"{i}-{side}.out"), "w") as f:
            f.write(text + json.dumps(cold) + "\n")
        runs[side].append(rows)
        colds[side].append(cold)
        print(f"run {i} {side}: {len(rows)} shapes, cold {cold}", flush=True)
    for shape in runs["this"][0]:
        cells = []
        for side in ("other", "this"):
            vals = [r[shape] for r in runs[side] if shape in r]
            ms, bound, wrapped, host = (statistics.median(v[k] for v in vals)
                                        for k in range(4))
            cells.append(f"{side}: graph {ms:.4f} ms ({bound / ms:.2%} of "
                         f"bound {bound:.6f}), wrapper {wrapped:.4f} ms, host "
                         f"{host:.1f} us")
        print(f"{shape}: " + "; ".join(cells))
    for side in ("other", "this"):
        firsts = [c["first"] for c in colds[side]]
        print(f"cold start {side}: first panda_fk "
              f"{[round(f[0], 4) for f in firsts]} s, first sdf_query "
              f"{[round(f[1], 4) for f in firsts]} s, imported "
              f"{sorted({m for c in colds[side] for m in c['heavy']})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
