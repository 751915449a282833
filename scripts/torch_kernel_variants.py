"""Time the design steps of kernels K1 and K2 of the PyTorch port against a
checkout of an earlier version of the port, and K3's two block shapes, on one
NVIDIA GPU.

    python3 scripts/torch_kernel_variants.py --parent DIR [--out FILE]
    python3 scripts/torch_kernel_variants.py --only k3 [--out FILE]

``DIR`` holds an earlier checkout of the repository (for example a
``git archive`` of the parent commit unpacked under ``build/``); its
``husky_rover_mppi_isaacsim_torch/csrc/{rollout,edt_minplus}.cu`` are the
"parent" kernels, called with their own contract (a start heading already
projected on the start cell, velocities transposed to (H, K)). K1 is timed
in four variants at the shapes of the rollout paths:

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
needs no parent checkout. The register report of
each build and a summary of each kernel's SASS (``cuobjdump -sass``) are
printed too. Each result is one JSON line; all of them also go to ``FILE`` (default
``build/kernel_variants.json``).
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
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_K1_ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      ctypes.c_float, _I, _P]


def _ok(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {rc}")


def build_steps(cuda_build, kernel_source: str, steps_source: str):
    """Build ``csrc/<kernel_source>`` with ``scripts/kernel_steps/
    <steps_source>`` appended, as one source (so the library's cache key
    covers both)."""
    src = ROOT / "build" / "kernel_steps" / steps_source
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text((cuda_build.CSRC / kernel_source).read_text() + "\n"
                   + (STEPS / steps_source).read_text())
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
    ap.add_argument("--only", choices=["k3"])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_variants.json")
    args = ap.parse_args(argv)
    if args.only is None and args.parent is None:
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
    emit(phase="k3_variants", lanes=gp.K, table=[gp.P, gp.P], graph_ms=times,
         bit_equal={v: torch.equal(outs[v], want) for v in outs},
         ptxas=[ln.strip() for ln in (k3.log + k3_steps.log).splitlines()
                if "registers" in ln])
    if args.only == "k3":
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
        return 0

    parent_src = args.parent.resolve() / "husky_rover_mppi_isaacsim_torch" / "csrc"
    new_k1, new_k2 = rollout_25d_cuda.load(), edt_minplus_cuda.load()
    steps_k1 = build_steps(cuda_build, "rollout.cu", "rollout_steps.cu")
    steps_k2 = build_steps(cuda_build, "edt_minplus.cu", "edt_fmin.cu")
    steps_k1.lib.rollout25d_stage_f32.argtypes = ARGTYPES + [_I]
    steps_k1.lib.rollout25d_stage_f32.restype = _I
    steps_k2.lib.edt_minplus_fmin_f32.argtypes = [_P, _P, _I, _I, _P]
    steps_k2.lib.edt_minplus_fmin_f32.restype = _I
    old_k1 = cuda_build.build(parent_src / "rollout.cu")
    old_k2 = cuda_build.build(parent_src / "edt_minplus.cu")
    old_k1.lib.rollout25d_f32.argtypes = PARENT_K1_ARGTYPES
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

        def parent(o=outs["parent"]):
            _ok(old_k1.lib.rollout25d_f32(
                hf.z.data_ptr(), 1500, 1500, hf.resolution.data_ptr(), hf.x_min.data_ptr(),
                hf.y_min.data_ptr(), pos.data_ptr(), head0.data_ptr(), lin_t.data_ptr(),
                ang_t.data_ptr(), o.data_ptr(), n, k, h, DT, int(wheels), stream()))

        def stage(number, o):
            def run():
                a = (hf.z.data_ptr(), 1500, 1500, hf.resolution.data_ptr(), hf.x_min.data_ptr(),
                     hf.y_min.data_ptr(), pos.data_ptr(), pos.stride(0), pos.stride(1),
                     head.data_ptr(), head.stride(0), head.stride(1), lin.data_ptr(),
                     lin.stride(0), ang.data_ptr(), ang.stride(0), o.data_ptr(), n, k, h, DT,
                     int(wheels), stream())
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
        emit(phase="k2_variants", map=name, shape=list(g2.shape),
             bit_equal_to_dpx={v: torch.equal(outs[v], outs["dpx"]) for v in ("parent", "fmin")},
             **times)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
