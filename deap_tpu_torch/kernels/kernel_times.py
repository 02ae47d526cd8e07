"""Time K2 and K5 of a checkout of this package on the card.

    python deap_tpu_torch/kernels/kernel_times.py [--root DIR] [--label L]

Imports ``deap_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels and prints one JSON line per kernel
and input, CUDA-event milliseconds per launch beside the card's name and
power limit:

* K2 ``launch_gather_vary`` at 10⁶ × 100 in float32, bfloat16 and int8
  (the flagship's shape and knobs; winners from a random order and
  random positions);
* K5 ``launch_hv3d_sweep`` (128 prefixes a partial) on 8192 uniform
  points at ref (1, 1, 1) and on 10⁵ points of the DTLZ2 front (the unit
  sphere's positive octant) at ref (1.1, 1.1, 1.1), float32 and float64.

Only the two wrappers' public signatures are used, so two checkouts can
be timed in one call on one card (parent, change, change, parent).
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

POP, DIM = 1_000_000, 100
KNOBS = (0.9, 0.5, 0.0, 0.3, 0.05)


def cuda_ms(fn, reps: int, warm: int) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--label", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also print K5's device time by CUDA kernel")
    ap.add_argument("--ablate", action="store_true",
                    help="also time K2 without mutation and as a copy")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times.py needs a CUDA card", file=sys.stderr)
        return 1
    from deap_tpu_torch import kernels, random
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.ops import hypervolume as H
    from deap_tpu_torch.probes import card_line
    kernels.load()
    card = card_line()
    label = args.label or os.fspath(args.root)
    dev = torch.device("cuda")

    def emit(**fields):
        print(json.dumps({"root": label, "card": card, **fields}),
              flush=True)

    k_g, k_o, k_p, k_s, k_h = random.split(random.PRNGKey(0, device=dev), 5)
    genome = random.uniform(k_g, (POP, DIM), minval=-5.12, maxval=5.12)
    order = torch.argsort(random.uniform(k_o, (POP,))).to(torch.int32)
    pos = random.randint(k_p, (POP,), 0, POP)
    seed = G._seed_from_key(k_s)
    knobs = torch.tensor(KNOBS, dtype=torch.float32, device=dev)
    variants = {"flagship": knobs}
    if args.ablate:        # mutpb 0: no draw 3 or erf_inv; then no swap
        variants["no mutation"] = torch.tensor(
            (KNOBS[0], 0.0) + KNOBS[2:], dtype=torch.float32, device=dev)
        variants["copy"] = torch.tensor(
            (0.0, 0.0) + KNOBS[2:], dtype=torch.float32, device=dev)
    for st in (G.GenomeStorage("float32"), G.GenomeStorage("bfloat16"),
               G.GenomeStorage("int8", 5.12)):
        gs = st.to_storage(genome)
        for variant, kn in variants.items():
            ms = cuda_ms(lambda: kernels.launch_gather_vary(
                order, pos, gs, seed, kn, dim=DIM, dtype=st.dtype,
                scale=st.scale), reps=20, warm=3)
            emit(kernel="megakernel_gather_vary", dtype=st.dtype,
                 shape=[POP, DIM], knobs=variant, ms=ms)
        del gs
    del genome
    torch.cuda.empty_cache()

    k_u, k_f = random.split(k_h)
    sphere = random.uniform(k_f, (100_000, 3)) + 1e-3
    sphere = sphere / sphere.norm(dim=1, keepdim=True)
    for name, pts, ref in (
            ("8192 uniform", random.uniform(k_u, (8192, 3)), (1.0,) * 3),
            ("1e5 DTLZ2 front", sphere, (1.1,) * 3)):
        for dtype in (torch.float32, torch.float64):
            clipped, r = H._as_points(pts.to(dtype), ref)
            _, ys, zr, dz, width = H._hv3d_prep(clipped, r)
            ys, zr, width, dz = (t.contiguous() for t in (ys, zr, width, dz))
            ref_y = float(torch.tensor(ref, dtype=dtype)[1])
            ms = cuda_ms(lambda: kernels.launch_hv3d_sweep(
                ys, zr, width, dz, ref_y, threads=128), reps=10, warm=2)
            by = _device_ms(lambda: kernels.launch_hv3d_sweep(
                ys, zr, width, dz, ref_y, threads=128)) if args.profile \
                else None
            emit(kernel="hv3d_sweep", input=name, n=pts.shape[0],
                 dtype=str(dtype).split(".")[1], ms=ms, device_ms_by=by)
    return 0


def _device_ms(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by CUDA kernel (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            out[ev.key[:60]] = t / 1e3 / reps
    return out


if __name__ == "__main__":
    sys.exit(main())
