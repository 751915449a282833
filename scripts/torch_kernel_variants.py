"""Time the design steps of kernels K1 and K2 and of the planar rollout kernel
of the PyTorch port against a checkout of an earlier version of the port, and
K3's two block shapes, on one NVIDIA GPU.

    python3 scripts/torch_kernel_variants.py --parent DIR [--out FILE]
    python3 scripts/torch_kernel_variants.py --only k3 [--out FILE]
    python3 scripts/torch_kernel_variants.py --only planar --parent DIR [--out FILE]
    python3 scripts/torch_kernel_variants.py --only jax_normal --parent DIR [--out FILE]

``DIR`` holds an earlier checkout of the repository (for example a
``git archive`` of the parent commit unpacked under ``build/``); its
``husky_rover_mppi_isaacsim_torch/csrc/{rollout,edt_minplus}.cu`` are the
"parent" kernels, called with their own contract: an early K1 takes a start
heading already projected on the start cell and velocities transposed to
(H, K), a K1 whose entry has per-rover strides this checkout's contract.
K1 is timed in four variants at the shapes of the rollout paths:

* ``parent``: the earlier kernel alone, its inputs prepared beforehand;
* ``stage1``: inputs staged in shared memory and the start projection in
  the kernel, one warp doing everything;
* ``stage2``: + the chain / store warp split;
* ``stage3``: + the chain's divisions and square roots branch-free: this
  checkout's kernel, the one the rollout paths launch.

Stages 1 and 2 come from ``scripts/kernel_steps/rollout_steps.cu``, built
appended to this checkout's ``csrc/rollout.cu`` under
``build/kernel_steps/``, so that they share its setup, arithmetic and store
warps.

Each is timed back to back (CUDA events around 20 launches) and as one CUDA
graph replay of 20 launches, in turns (parent, stage1, stage2, stage3, and
back), median of 7. Every variant's output is held bit-equal to stage 3's.
K2 is timed the same two ways on the 750^2, 1500^2 and 187 x 875 maps: the
parent kernel, this checkout's with two float mins per candidate pair
(``fmin``, ``scripts/kernel_steps/edt_fmin.cu`` appended to
``csrc/edt_minplus.cu``) and with the DPX three-way min (``dpx``, the kernel
the costmap build launches), each held bit-equal to ``dpx``. K3 is timed by
graph replay in its production shape (8 blocks of 128 threads) and as one
block of 1024 threads (``scripts/kernel_steps/gather_probe_1024.cu``), each
beside an empty kernel of the same grid and block (the launch floor) and the
one-call ``table[j, i]``, in turns; ``--only k3`` runs that part alone and
needs no parent checkout. The planar rollout kernel (``csrc/rollout_2d.cu``)
is timed the same two ways at K in {1, 350, 500, 1000} x H = 100 on the
1500^2 thesis DEM, in turns: the parent's ``rollout_2d.cu`` (one thread per
sample), the variants of ``scripts/kernel_steps/rollout_2d_steps.cu`` (32
samples per block; 8 store warps; the chain cut into a heading and a
position warp) and this checkout's kernel, each held bit-equal to the last,
and that one to the plain ``rollout_2d``; then
this kernel alone by graph replay at K = 1000 over horizons from 1 to 256
(the slope is a step's cost). ``--only planar`` runs that part alone. The
``jax_normal`` kernel (``csrc/jax_normal.cu``) is timed by graph replay at
the loops' draws ((2, 1000, 100), (2, 16384, 64), (2, 4000, 100), (4,)),
in turns: the parent's kernel, the variants of
``scripts/kernel_steps/jax_normal_steps.cu`` (1, 2 or 4 values a thread a
trip; the key derived by warp 0 behind a barrier or by every warp) and this
checkout's kernel, beside the empty kernel of this one's grid, each held
``torch.equal`` to the plain ``jax_random.normal``. ``--only jax_normal``
runs that part alone. The register report of each build and a summary of
each kernel's SASS (``cuobjdump -sass``) are printed too. Each result is one JSON line; all of
them also go to ``FILE`` (default ``build/kernel_variants.json``). A variant
(the parent included) that is not bit-equal to what it is held to stops the
run with an error, after its line is printed: a parent called with the
wrong argument list shows there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = ROOT / "scripts" / "kernel_steps"
sys.path.insert(0, str(ROOT))

H, DT = 100, 0.045
# (rovers N, samples K, horizon H, wheels): the flagship's two launches, the
# closed loop's, and a ragged shape (slices not 16-byte aligned)
K1_SHAPES = [(1, 1000, H, True), (1, 1000, H, False), (1, 1, H, False),
             (4, 1000, H, True), (4, 1000, H, False), (4, 1, H, False),
             (1, 33, 37, True), (4, 33, 37, True)]
# the planar rollout kernel: the 2D arm's K values and the K = 1 launch floor
PLANAR_KS = (1, 350, 500, 1000)
# rollout2d_variant_f32's variants (scripts/kernel_steps/rollout_2d_steps.cu)
PLANAR_VARIANTS = {"s32_w8": 1, "s16_w8": 2, "position_warp": 3}
# the production kernel's horizon sweep at K = 1000: a step's cost is the slope
PLANAR_SWEEP_HS = (1, 8, 25, 50, 100, 150, 200, 256)
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_K1_ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      ctypes.c_float, _I, _P]


def _ok(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {rc}")


def require_equal(phase: str, equal: dict) -> None:
    """Stop the run where a variant's output is not bit-equal to its reference."""
    wrong = [v for v, same in equal.items() if not same]
    if wrong:
        raise RuntimeError(f"{phase}: not bit-equal: {', '.join(wrong)}")


def build_steps(cuda_build, kernel_source: str, steps_source: str):
    """Build ``csrc/<kernel_source>`` with ``scripts/kernel_steps/
    <steps_source>`` appended, as one source (so the library's cache key
    covers both), its local headers included from ``csrc/`` by path."""
    src = ROOT / "build" / "kernel_steps" / steps_source
    src.parent.mkdir(parents=True, exist_ok=True)
    kernel = re.sub(r'^#include "([^"/]+)"',
                    lambda m: f'#include "{cuda_build.CSRC / m.group(1)}"',
                    (cuda_build.CSRC / kernel_source).read_text(), flags=re.MULTILINE)
    src.write_text(kernel + "\n" + (STEPS / steps_source).read_text())
    return cuda_build.build(src)


def sass_summary(lib: Path) -> dict:
    """Instruction counts of each kernel in ``lib``'s SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"instructions": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(2).split(".")[0]
            out[name]["instructions"] += 1
            if op in ("BRA", "CALL", "BSSY", "MUFU", "LDG", "STG", "LDS", "STS", "SYNCS",
                      "FMNMX", "FADD", "FMUL"):
                out[name][op] = out[name].get(op, 0) + 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--only", choices=["k3", "planar", "jax_normal"])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_variants.json")
    args = ap.parse_args(argv)
    if args.only != "k3" and args.parent is None:
        ap.error("--parent is required unless --only k3 is given")

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from husky_rover_mppi_isaacsim_torch.core import HeightField
    from husky_rover_mppi_isaacsim_torch.mppi.rollout import start_heading
    from husky_rover_mppi_isaacsim_torch.ops import cuda_build
    from husky_rover_mppi_isaacsim_torch.ops import gather_probe as gp
    from husky_rover_mppi_isaacsim_torch.ops.edt import row_distances_sq
    from husky_rover_mppi_isaacsim_torch.ops.edt_cuda import edt_minplus_cuda
    from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import ARGTYPES, rollout_25d_cuda
    from husky_rover_mppi_isaacsim_torch.ops.measure import cuda_ms, graph_ms
    from husky_rover_mppi_isaacsim_torch.terrain import (
        STANDALONE_CRATER_BUMPS,
        crater_surface,
        generate_obstacles,
        rasterize_obstacles,
    )

    results = []

    def emit(**fields):
        results.append(fields)
        print(json.dumps(fields), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0))

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    cuda = torch.device("cuda")

    def finish():
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
        return 0

    if args.only == "planar":
        planar_variants(args.parent.resolve() / "husky_rover_mppi_isaacsim_torch" / "csrc",
                        emit, cuda, stream)
        return finish()
    if args.only == "jax_normal":
        jax_normal_variants(args.parent.resolve() / "husky_rover_mppi_isaacsim_torch" / "csrc",
                            emit, cuda, stream)
        return finish()

    # K3: 8 blocks of 128 threads (production) against one block of 1024,
    # each beside its empty kernel and the one-call table[j, i]
    k3 = gp.gather_probe_cuda.load()
    k3_steps = build_steps(cuda_build, "gather_probe.cu", "gather_probe_1024.cu")
    k3_steps.lib.gather_probe_1024_f32.argtypes = [_P, _I, _I, _P, _P, _P, _I, _P]
    k3_steps.lib.gather_probe_1024_f32.restype = _I
    k3_steps.lib.gather_probe_floor_1024.argtypes = [_P]
    k3_steps.lib.gather_probe_floor_1024.restype = _I
    table, idx_i, idx_j = gp.probe_inputs(cuda)
    outs = {v: torch.empty((gp.K,), device=cuda) for v in ("8x128", "1x1024")}
    k3_variants = {
        "8x128": lambda: gp.gather_probe_cuda.launch(table, idx_i, idx_j, outs["8x128"]),
        "floor_8x128": lambda: gp.gather_probe_cuda.launch_floor(gp.K),
        "1x1024": lambda: _ok(k3_steps.lib.gather_probe_1024_f32(
            table.data_ptr(), gp.P, gp.P, idx_i.data_ptr(), idx_j.data_ptr(),
            outs["1x1024"].data_ptr(), gp.K, stream())),
        "floor_1x1024": lambda: _ok(k3_steps.lib.gather_probe_floor_1024(stream())),
        "library_getitem": lambda: table[idx_j, idx_i],
    }
    order = list(k3_variants)
    times = {v: [] for v in order}
    for v in order + order[::-1] + order:
        times[v].append(graph_ms(k3_variants[v]))
    torch.cuda.synchronize()
    want = gp.gather_getitem(table, idx_i, idx_j)
    equal = {v: torch.equal(outs[v], want) for v in outs}
    emit(phase="k3_variants", lanes=gp.K, table=[gp.P, gp.P], graph_ms=times,
         bit_equal=equal, ptxas=[ln.strip() for ln in (k3.log + k3_steps.log).splitlines()
                                 if "registers" in ln])
    require_equal("k3_variants", equal)
    if args.only == "k3":
        return finish()

    parent_src = args.parent.resolve() / "husky_rover_mppi_isaacsim_torch" / "csrc"
    planar_variants(parent_src, emit, cuda, stream)
    jax_normal_variants(parent_src, emit, cuda, stream)
    new_k1, new_k2 = rollout_25d_cuda.load(), edt_minplus_cuda.load()
    steps_k1 = build_steps(cuda_build, "rollout.cu", "rollout_steps.cu")
    steps_k2 = build_steps(cuda_build, "edt_minplus.cu", "edt_fmin.cu")
    steps_k1.lib.rollout25d_stage_f32.argtypes = ARGTYPES + [_I]
    steps_k1.lib.rollout25d_stage_f32.restype = _I
    steps_k2.lib.edt_minplus_fmin_f32.argtypes = [_P, _P, _I, _I, _P]
    steps_k2.lib.edt_minplus_fmin_f32.restype = _I
    old_k1 = cuda_build.build(parent_src / "rollout.cu")
    old_k2 = cuda_build.build(parent_src / "edt_minplus.cu")
    # a parent K1 whose entry has per-rover strides takes this checkout's arguments
    k1_same_contract = "long long pos_sn" in (parent_src / "rollout.cu").read_text()
    old_k1.lib.rollout25d_f32.argtypes = ARGTYPES if k1_same_contract else PARENT_K1_ARGTYPES
    old_k1.lib.rollout25d_f32.restype = _I
    old_k2.lib.edt_minplus_f32.argtypes = [_P, _P, _I, _I, _P]
    old_k2.lib.edt_minplus_f32.restype = _I
    for name, built in (("k1", new_k1), ("k2", new_k2), ("k1_steps", steps_k1),
                        ("k2_fmin", steps_k2), ("k1_parent", old_k1), ("k2_parent", old_k2)):
        emit(phase="build", kernel=name, nvcc_seconds=built.seconds,
             ptxas=[ln.strip() for ln in built.log.splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln],
             sass=sass_summary(built.path))

    hf = HeightField.create(crater_surface(1500, 75.0, STANDALONE_CRATER_BUMPS, device=cuda),
                            75.0)
    gen = torch.Generator(device=cuda).manual_seed(0)

    for n, k, h, wheels in K1_SHAPES:
        pos = torch.rand((n, 2), generator=gen, device=cuda) * 80.0 - 40.0
        head = torch.rand((n, 3), generator=gen, device=cuda) - 0.5
        lin = torch.rand((n, k, h), generator=gen, device=cuda) * 2.0
        ang = torch.rand((n, k, h), generator=gen, device=cuda) * 2.0 - 1.0
        channels = 12 if wheels else 6
        names = ("parent", "stage1", "stage2", "stage3")
        outs = {v: torch.empty((channels, n, h, k), device=cuda) for v in names}
        head0 = start_heading(hf, pos, head).contiguous()
        lin_t, ang_t = lin.transpose(1, 2).contiguous(), ang.transpose(1, 2).contiguous()

        def k1_args(o):
            """This checkout's K1 entry arguments, writing into ``o``."""
            return (hf.z.data_ptr(), 1500, 1500, hf.resolution.data_ptr(), hf.x_min.data_ptr(),
                    hf.y_min.data_ptr(), pos.data_ptr(), pos.stride(0), pos.stride(1),
                    head.data_ptr(), head.stride(0), head.stride(1), lin.data_ptr(),
                    lin.stride(0), ang.data_ptr(), ang.stride(0), o.data_ptr(), n, k, h, DT,
                    int(wheels), stream())

        def parent(o=outs["parent"]):
            if k1_same_contract:
                _ok(old_k1.lib.rollout25d_f32(*k1_args(o)))
                return
            _ok(old_k1.lib.rollout25d_f32(
                hf.z.data_ptr(), 1500, 1500, hf.resolution.data_ptr(), hf.x_min.data_ptr(),
                hf.y_min.data_ptr(), pos.data_ptr(), head0.data_ptr(), lin_t.data_ptr(),
                ang_t.data_ptr(), o.data_ptr(), n, k, h, DT, int(wheels), stream()))

        def stage(number, o):
            def run():
                a = k1_args(o)
                _ok(new_k1.lib.rollout25d_f32(*a) if number == 3
                    else steps_k1.lib.rollout25d_stage_f32(*a, number))
            return run

        variants = {"parent": parent, **{f"stage{i}": stage(i, outs[f"stage{i}"])
                                         for i in (1, 2, 3)}}
        times = {v: {"back_to_back_ms": [], "graph_ms": []} for v in variants}
        for v in names + names[::-1]:
            times[v]["back_to_back_ms"].append(cuda_ms(variants[v], inner=20))
            times[v]["graph_ms"].append(graph_ms(variants[v]))
        torch.cuda.synchronize()
        equal = {v: torch.equal(outs[v], outs["stage3"]) for v in names[:3]}
        emit(phase="k1_variants", N=n, K=k, H=h, wheels=wheels, bit_equal_to_stage3=equal,
             **times)
        require_equal("k1_variants", equal)

    def occupancy(size):
        raster = rasterize_obstacles(generate_obstacles(), half_width=75.0, size=size,
                                     robot_radius=0.3)
        return torch.from_numpy(raster == 0).to(cuda)

    maps = {"standalone_750": occupancy(750), "thesis_1500": occupancy(1500),
            "random_187x875": torch.rand((187, 875), generator=gen, device=cuda) < 0.02}
    for name, occ in maps.items():
        g2 = row_distances_sq(occ)
        entries = {"parent": old_k2.lib.edt_minplus_f32,
                   "fmin": steps_k2.lib.edt_minplus_fmin_f32, "dpx": new_k2.lib.edt_minplus_f32}
        outs = {v: torch.empty_like(g2) for v in entries}

        def k2(v):
            def run():
                _ok(entries[v](g2.data_ptr(), outs[v].data_ptr(), g2.shape[0], g2.shape[1],
                               stream()))
            return run

        times = {v: {"back_to_back_ms": [], "graph_ms": []} for v in entries}
        for v in ("parent", "fmin", "dpx", "dpx", "fmin", "parent"):
            times[v]["back_to_back_ms"].append(cuda_ms(k2(v)))
            times[v]["graph_ms"].append(graph_ms(k2(v)))
        torch.cuda.synchronize()
        equal = {v: torch.equal(outs[v], outs["dpx"]) for v in ("parent", "fmin")}
        emit(phase="k2_variants", map=name, shape=list(g2.shape), bit_equal_to_dpx=equal,
             **times)
        require_equal("k2_variants", equal)

    return finish()


def planar_variants(parent_src: Path, emit, cuda, stream) -> None:
    """The planar rollout kernel: builds, then each K of PLANAR_KS timed in
    turns (parent, variants, this kernel, and back), held bit-equal."""
    import torch

    from husky_rover_mppi_isaacsim_torch.core import HeightField
    from husky_rover_mppi_isaacsim_torch.mppi.rollout import rollout_2d
    from husky_rover_mppi_isaacsim_torch.ops import cuda_build
    from husky_rover_mppi_isaacsim_torch.ops.measure import cuda_ms, graph_ms
    from husky_rover_mppi_isaacsim_torch.ops.rollout_2d_cuda import ARGTYPES, rollout_2d_cuda
    from husky_rover_mppi_isaacsim_torch.terrain import thesis_statistics_terrain

    new = rollout_2d_cuda.load()
    steps = build_steps(cuda_build, "rollout_2d.cu", "rollout_2d_steps.cu")
    steps.lib.rollout2d_variant_f32.argtypes = ARGTYPES + [_I]
    steps.lib.rollout2d_variant_f32.restype = _I
    old = cuda_build.build(parent_src / "rollout_2d.cu")
    old.lib.rollout2d_f32.argtypes = ARGTYPES
    old.lib.rollout2d_f32.restype = _I
    for name, built in (("planar", new), ("planar_steps", steps), ("planar_parent", old)):
        emit(phase="build", kernel=name, nvcc_seconds=built.seconds,
             ptxas=[ln.strip() for ln in built.log.splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln],
             sass=sass_summary(built.path))

    hf = HeightField.create(thesis_statistics_terrain(device=cuda), 75.0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    pos = torch.tensor([-60.0, 10.0], device=cuda)  # the 2D arm's start band
    head = torch.tensor([0.8, 0.6, 0.0], device=cuda)
    names = ("parent", *PLANAR_VARIANTS, "this")
    for k in PLANAR_KS:
        lin = torch.rand((k, H), generator=gen, device=cuda) * 2.0
        ang = torch.rand((k, H), generator=gen, device=cuda) * 2.0 - 1.0
        outs = {v: torch.zeros((2, k, H, 3), device=cuda) for v in names}

        def call(v):
            def run():
                a = (hf.z.data_ptr(), hf.z.shape[0], hf.z.shape[1], hf.resolution.data_ptr(),
                     hf.x_min.data_ptr(), hf.y_min.data_ptr(), pos.data_ptr(), 0, pos.stride(0),
                     head.data_ptr(), 0, head.stride(0), lin.data_ptr(), 0, ang.data_ptr(), 0,
                     outs[v].data_ptr(), 1, k, H, DT, stream())
                if v == "parent":
                    _ok(old.lib.rollout2d_f32(*a))
                elif v == "this":
                    _ok(new.lib.rollout2d_f32(*a))
                else:
                    _ok(steps.lib.rollout2d_variant_f32(*a, PLANAR_VARIANTS[v]))
            return run

        times = {v: {"back_to_back_ms": [], "graph_ms": []} for v in names}
        for v in names + names[::-1]:
            times[v]["back_to_back_ms"].append(cuda_ms(call(v), inner=20))
            times[v]["graph_ms"].append(graph_ms(call(v)))
        want = rollout_2d(hf, pos[None], head[None], lin, ang, DT)
        torch.cuda.synchronize()
        this = outs["this"]
        equal = {v: torch.equal(outs[v], this) for v in names[:-1]}
        plain = all(torch.equal(a, b) for a, b in zip(this, want))
        emit(phase="planar_variants", K=k, H=H, dem=list(hf.z.shape),
             bit_equal_to_this=equal, this_bit_equal_to_plain=plain, **times)
        require_equal("planar_variants", {**equal, "this_to_plain": plain})

    sweep = {}
    for h in PLANAR_SWEEP_HS:
        lin = torch.rand((1000, h), generator=gen, device=cuda) * 2.0
        ang = torch.rand((1000, h), generator=gen, device=cuda) * 2.0 - 1.0
        out = torch.empty((2, 1000, h, 3), device=cuda)
        sweep[h] = graph_ms(lambda: rollout_2d_cuda.launch(hf, pos, head, lin, ang, out, DT))
    emit(phase="planar_horizons", K=1000, graph_ms=sweep)


# the jax_normal draws timed: the goal-seek's, bench_torch.py's, the
# closed loop's (4 rovers) and the slip's; the variants of
# scripts/kernel_steps/jax_normal_steps.cu as (values a trip, warp key)
NORMAL_SHAPES = ((2, 1000, 100), (2, 16384, 64), (2, 4000, 100), (4,))
NORMAL_VARIANTS = {"v1_barrier": (1, 0), "v1_warp_key": (1, 1), "v2_barrier": (2, 0),
                   "v2_warp_key": (2, 1), "v4_barrier": (4, 0), "v4_warp_key": (4, 1)}


def jax_normal_variants(parent_src: Path, emit, cuda, stream) -> None:
    """The jax_normal kernel: each build's registers and SASS summary, then
    each draw of NORMAL_SHAPES timed in turns (parent, variants, this
    kernel, its empty kernel, and back), each held to the plain draw."""
    import numpy as np
    import torch

    from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
    from husky_rover_mppi_isaacsim_torch.ops import cuda_build
    from husky_rover_mppi_isaacsim_torch.ops.jax_normal_cuda import (
        ARGTYPES, SPLIT_SUB, jax_normal, key_path)
    from husky_rover_mppi_isaacsim_torch.ops.measure import graph_ms

    new = jax_normal.load()
    steps = build_steps(cuda_build, "jax_normal.cu", "jax_normal_steps.cu")
    steps.lib.jax_normal_variant_f32.argtypes = [_I, _I, _P, _I, ctypes.c_uint32,
                                                 ctypes.c_longlong, _P, _P]
    steps.lib.jax_normal_variant_f32.restype = _I
    old = cuda_build.build(parent_src / "jax_normal.cu")
    old.lib.jax_normal_f32.argtypes = ARGTYPES
    old.lib.jax_normal_f32.restype = _I
    key = jr.key(42, cuda)
    sub = jr.derive(key, SPLIT_SUB)
    kp, _ = key_path(SPLIT_SUB, cuda)
    for name, built in (("jax_normal", new), ("jax_normal_steps", steps),
                        ("jax_normal_parent", old)):
        emit(phase="build", kernel=name, nvcc_seconds=built.seconds,
             ptxas=[ln.strip() for ln in built.log.splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln],
             sass=sass_summary(built.path))
    names = ("parent", *NORMAL_VARIANTS, "this", "floor")
    for shape in NORMAL_SHAPES:
        n = int(np.prod(shape))
        outs = {v: torch.empty(shape, device=cuda) for v in names}

        def call(v):
            def run():
                if v == "parent":
                    _ok(old.lib.jax_normal_f32(key.data_ptr(), kp.len, kp.device_step, *kp.v, 0,
                                               -1, 0, 0, 0, 0, None, 0, 1, 0, n,
                                               outs[v].data_ptr(), None, stream()))
                elif v == "this":
                    jax_normal(key, shape, path=SPLIT_SUB)
                elif v == "floor":
                    jax_normal.launch_floor(n)
                else:
                    _ok(steps.lib.jax_normal_variant_f32(*NORMAL_VARIANTS[v], key.data_ptr(),
                                                         kp.len, kp.v[0], n, outs[v].data_ptr(),
                                                         stream()))
            return run

        times = {v: [] for v in names}
        for v in names + names[::-1] + names:
            times[v].append(graph_ms(call(v)))
        outs["this"] = jax_normal(key, shape, path=SPLIT_SUB)
        want = jr.normal(sub, shape)
        torch.cuda.synchronize()
        equal = {v: torch.equal(outs[v], want) for v in names if v != "floor"}
        emit(phase="jax_normal_variants", shape=list(shape), n=n, graph_ms=times,
             bit_equal_to_plain=equal)
        require_equal("jax_normal_variants", equal)


if __name__ == "__main__":
    sys.exit(main())
