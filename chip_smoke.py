"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the 256^3 bench configuration

Phases (any failure exits non-zero and prints no result line):
  1. require CUDA; print the card (nvidia-smi) and the torch / CUDA versions;
  2. build the CUDA kernels from csrc/ (nvcc) and print the build time;
  3. main path at 256^3 in the bench configuration (solve fp32, V-cycle
     fp32 with bf16 edge weights, tol 1e-5, 200 iterations): the port's
     splash_scene -> build_setup -> project, with every kernel launch
     counter reset just before and read just after; the counts must equal
     what the hierarchy and the iteration count imply;
  4. each kernel against its plain PyTorch version on random inputs (a
     seeded torch.Generator) on the levels of that hierarchy, with bf16 and
     fp32 edge weights, and each kernel's time beside the plain version's at
     the fine-level shape;
  5. the best of 3 solve times (mgpcg.solve, as bench.py times the JAX
     package) with the kernels and with kernel_mode="torch", and the two
     projections compared;
  6. a small fp64 projection on the card checked against a direct sparse
     solve of the assembled system.
The last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed nothing")
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` over `reps` calls, CUDA events."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that divided by max |want|)."""
    diff = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return diff, diff / max(scale, 1e-300)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=256, help="scene size (default 256)")
    args = parser.parse_args(argv)

    import torch

    # ---- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg

    from geometricmultigridpressuresolver_tpu_torch.config import SolverConfig
    from geometricmultigridpressuresolver_tpu_torch.models import free_surface, sdf
    from geometricmultigridpressuresolver_tpu_torch.ops import _cuda, fused_cg, fused_smoother
    from geometricmultigridpressuresolver_tpu_torch.solver import mgpcg

    torch.backends.cuda.matmul.allow_tf32 = False  # the coarse matmul in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build -------------------------------------------------------------
    _cuda.library()
    info = _cuda.build_info
    print(f"[2] kernels {'built' if info.compiled else 'loaded'} in {info.seconds:.1f} s: {info.path.name}")
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", info.log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", info.log))
    print(f"[2] ptxas: {len(regs)} kernels, at most {max(regs, default=0)} registers "
          f"per thread, {spills} bytes of spills")

    # ---- 3. main path -----------------------------------------------------------
    n = args.n
    config = SolverConfig(
        solve_dtype=torch.float32, mg_dtype=torch.float32, mg_ew_dtype=torch.bfloat16,
        tolerance=1e-5, max_iterations=200,
    )
    counters = (fused_smoother.PASS_LAUNCHES, fused_cg.STEP_LAUNCHES, fused_cg.RESIDUAL_LAUNCHES)
    for c in counters:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    liquid_phi, velocity = sdf.splash_scene((n, n, n), device=dev, dtype=torch.float32)
    weights = sdf.open_box_weights((n, n, n), device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t_scene, t0 = time.perf_counter() - t0, time.perf_counter()
    setup = free_surface.build_setup(liquid_phi, weights, config=config)
    torch.cuda.synchronize()
    t_setup, t0 = time.perf_counter() - t0, time.perf_counter()
    result = free_surface.project(setup, velocity, config=config)
    torch.cuda.synchronize()
    t_project = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}

    hier = setup.problem.hier
    nlev = hier.num_levels
    ndof = int(setup.problem.fine.solvable.sum())
    iters = result.cg.iterations
    print(f"[3] scene {t_scene:.2f} s, setup {t_setup:.2f} s, first project {t_project:.2f} s")
    print(f"[3] expanded {setup.expanded_shape}, levels {[tuple(c.shape) for c in hier.levels]}, "
          f"coarse system {tuple((hier.coarse_minv if hier.coarse_minv.numel() else hier.coarse_chol).shape)}")
    print(f"[3] liquid DOFs {ndof:,}; iterations {iters}; relative residual "
          f"{result.cg.relative_residual:.3e}; recomputed {float(result.residual_rel_l2):.3e} "
          f"(linf {float(result.residual_linf):.3e}); max divergence "
          f"{float(result.max_divergence):.3e}, avg {float(result.avg_divergence):.3e}")
    print(f"[3] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(result.cg.converged and result.cg.relative_residual <= 1e-5, "did not converge to 1e-5")
    require(tuple(result.pressure.shape) == (n, n, n), "pressure shape")
    require(all(tuple(v.shape) == tuple(u.shape) for v, u in zip(result.velocity, velocity)),
            "velocity shapes")
    require(bool(torch.isfinite(result.pressure).all())
            and all(bool(torch.isfinite(v).all()) for v in result.velocity), "non-finite output")
    passes = len(fused_smoother.schedule_for(config, True))
    cycles = iters + 1
    smoothed = max(nlev - 1, 1)
    expected = {
        "smoother": passes * cycles * (2 * smoothed if nlev > 1 else 1),
        "residual": (nlev - 1) * cycles + 1,  # downstroke residuals + the recomputed one
        "cg_step": iters,
    }
    print(f"[3] kernel launches {launches}, expected {expected}")
    require(launches == expected, "launch counts differ from what the hierarchy implies")

    # ---- 4. kernels against their plain versions ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(20261016)

    def rand_field(c):
        v = torch.randn(c.shape, generator=gen, device=dev, dtype=torch.float32)
        return torch.where(c.solvable, v, torch.zeros_like(v))

    grid_tol, dot_tol = 1e-5, 1e-4  # fp32: FMA contraction and summation order
    errs = {"smoother": 0.0, "cg_step": 0.0, "residual": 0.0}  # grids, absolute
    dot_errs = {"smoother": 0.0, "cg_step": 0.0}  # dots, relative

    def check(name, what, got, want, tol):
        diff, rel = rel_err(got, want)
        if got.dim():
            errs[name] = max(errs[name], diff)
        else:
            dot_errs[name] = max(dot_errs[name], rel)
        require(rel <= tol, f"{name} {what}: relative error {rel:.3e} > {tol:g}")
        return rel

    smoothed_levels = hier.levels[:-1] if nlev > 1 else hier.levels
    worst = {}
    for lv, c_bf16 in enumerate(smoothed_levels):
        c_f32 = c_bf16._replace(ew0=c_bf16.ew0.float(), ew1=c_bf16.ew1.float(), ew2=c_bf16.ew2.float())
        for tag, c in (("bf16", c_bf16), ("fp32", c_f32)):
            x, b = rand_field(c), rand_field(c)
            cases = {
                "down(zero_x,emit_residual)": dict(x=None, forward=True, x_is_zero=True, emit_residual=True),
                "up": dict(x=x, forward=False),
                "up(emit_dot)": dict(x=x, forward=False, emit_dot=True),
                "down(warm)": dict(x=x, forward=True),
            }
            for case, kw in cases.items():
                xx = kw.pop("x")
                got = fused_smoother.smooth_level(xx, b, c, config, **kw)
                torch.cuda.synchronize()
                want = fused_smoother.smooth_level_torch(xx, b, c, config, **kw)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                key = f"L{lv} {tag} {case}"
                worst[key] = check("smoother", key + " x", got[0], want[0], grid_tol)
                if kw.get("emit_residual"):
                    check("smoother", key + " r", got[1], want[1], grid_tol)
                if kw.get("emit_dot"):
                    check("smoother", key + " dot", got[-1], want[-1], dot_tol)
            r_got = fused_cg.residual(x, b, c.diag, c.ew0, c.ew1, c.ew2, mode="cuda")
            torch.cuda.synchronize()
            r_want = fused_cg.residual_torch(x, b, c.diag, c.ew0, c.ew1, c.ew2)
            check("residual", f"L{lv} {tag}", r_got, r_want, grid_tol)
    fine = setup.problem.fine
    z, p = rand_field(fine), rand_field(fine)
    beta = torch.tensor(0.7371, dtype=torch.float32, device=dev)
    got = fused_cg.search_matvec_dot(z, p, beta, fine.diag, fine.ew0, fine.ew1, fine.ew2, mode="cuda")
    torch.cuda.synchronize()
    want = fused_cg.search_matvec_dot_torch(z, p, beta, fine.diag, fine.ew0, fine.ew1, fine.ew2)
    check("cg_step", "p'", got[0], want[0], grid_tol)
    check("cg_step", "Ap'", got[1], want[1], grid_tol)
    check("cg_step", "<p', Ap'>", got[2], want[2], dot_tol)
    print(f"[4] kernel vs plain: all within {grid_tol:g} (grids) / {dot_tol:g} (dots) relative; "
          f"max abs grid errors {errs}, max relative dot errors {dot_errs}")
    print(f"[4] worst smoother case: {max(worst, key=worst.get)} at {max(worst.values()):.3e} relative")

    # Times at the fine-level shape: the fine upstroke block with the rho dot
    # (8 passes), one CG step, one residual.
    c0 = hier.levels[0]
    x0f, b0f = rand_field(c0), rand_field(c0)
    reps = 20
    times = {
        "smoother": (
            cuda_ms(lambda: fused_smoother.smooth_level(x0f, b0f, c0, config, False, emit_dot=True), reps),
            cuda_ms(lambda: fused_smoother.smooth_level_torch(x0f, b0f, c0, config, False, emit_dot=True), reps),
        ),
        "cg_step": (
            cuda_ms(lambda: fused_cg.search_matvec_dot(z, p, beta, fine.diag, fine.ew0, fine.ew1, fine.ew2, mode="cuda"), reps),
            cuda_ms(lambda: fused_cg.search_matvec_dot_torch(z, p, beta, fine.diag, fine.ew0, fine.ew1, fine.ew2), reps),
        ),
        "residual": (
            cuda_ms(lambda: fused_cg.residual(x0f, b0f, c0.diag, c0.ew0, c0.ew1, c0.ew2, mode="cuda"), reps),
            cuda_ms(lambda: fused_cg.residual_torch(x0f, b0f, c0.diag, c0.ew0, c0.ew1, c0.ew2), reps),
        ),
    }
    for name, (k_ms, p_ms) in times.items():
        print(f"[4] {name} at {tuple(c0.shape)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")

    # ---- 5. solve times, kernels vs plain ---------------------------------------------
    rhs = free_surface.embed_window(
        free_surface.negative_divergence(
            setup.liquid_mask,
            tuple(v.to(torch.float32) for v in velocity), setup.weights,
        ),
        setup.window_start, setup.base_pads, setup.expanded_shape,
    )
    config_t = dataclasses.replace(config, kernel_mode="torch")

    def best_solve(cfg):
        best, res = float("inf"), None
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = mgpcg.solve(setup.problem, rhs, config=cfg)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best, res

    t_k, res_k = best_solve(config)
    t_t, res_t = best_solve(config_t)
    print(f"[5] solve best of 3: kernels {t_k:.4f} s ({res_k.iterations} iters, "
          f"{ndof / t_k:,.0f} DOF/s); plain torch {t_t:.4f} s ({res_t.iterations} iters, "
          f"{ndof / t_t:,.0f} DOF/s) [{card}]")
    plain = free_surface.project(setup, velocity, config=config_t)
    _, p_rel = rel_err(result.pressure, plain.pressure)
    print(f"[5] kernel vs plain projection: iterations {iters} vs {plain.cg.iterations}, "
          f"pressure max relative difference {p_rel:.3e}")
    require(abs(iters - plain.cg.iterations) <= 1, "iteration counts differ by more than 1")
    require(p_rel <= 1e-3, "kernel and plain pressures differ by more than 1e-3")
    require(res_k.iterations == iters, "re-solve iteration count changed")

    # ---- 6. small fp64 projection vs a direct solve of the assembled system -----------
    m = 24
    cfg64 = SolverConfig(tolerance=1e-12, max_iterations=200)
    phi_s, vel_s = sdf.splash_scene((m, m, m), device=dev)
    setup_s = free_surface.build_setup(phi_s, sdf.open_box_weights((m, m, m), device=dev), config=cfg64)
    res_s = free_surface.project(setup_s, vel_s, config=cfg64)
    f = setup_s.problem.fine
    solv = f.solvable.cpu().numpy().ravel()
    diag = f.diag.cpu().numpy().ravel()
    shape = f.shape
    index = -np.ones(solv.size, dtype=np.int64)
    index[solv] = np.arange(int(solv.sum()))
    rows, cols, vals = [index[solv]], [index[solv]], [diag[solv]]
    strides = (shape[1] * shape[2], shape[2], 1)
    for axis, ew in enumerate((f.ew0, f.ew1, f.ew2)):
        e = ew.double().cpu().numpy().ravel()
        cells = np.flatnonzero(e != 0)
        rows += [index[cells], index[cells + strides[axis]]]
        cols += [index[cells + strides[axis]], index[cells]]
        vals += [-e[cells], -e[cells]]
    a = scipy.sparse.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(int(solv.sum()),) * 2,
    )
    rhs_s = free_surface.embed_window(
        free_surface.negative_divergence(setup_s.liquid_mask, tuple(v.double() for v in vel_s), setup_s.weights),
        setup_s.window_start, setup_s.base_pads, setup_s.expanded_shape,
    ).cpu().numpy().ravel()
    x_direct = scipy.sparse.linalg.spsolve(a.tocsc(), rhs_s[solv])
    x_port = res_s.cg.x.cpu().numpy().ravel()[solv]
    oracle = float(np.abs(x_port - x_direct).max() / np.abs(x_direct).max())
    print(f"[6] {m}^3 fp64 on the card: {res_s.cg.iterations} iters, vs direct sparse solve "
          f"max relative difference {oracle:.3e}")
    require(res_s.cg.converged and oracle <= 1e-9, "fp64 projection disagrees with the direct solve")

    src = "geometricmultigridpressuresolver_tpu_torch/csrc/"
    kernels = [
        {"name": "smoother", "route": "cuda", "source": src + "smoother.cu",
         "replaces": "geometricmultigridpressuresolver_tpu/ops/pallas_smoother.py:619"},
        {"name": "cg_step", "route": "cuda", "source": src + "cg.cu",
         "replaces": "geometricmultigridpressuresolver_tpu/ops/pallas_cg.py:329"},
        {"name": "residual", "route": "cuda", "source": src + "cg.cu",
         "replaces": "geometricmultigridpressuresolver_tpu/ops/pallas_cg.py:253"},
    ]
    for k in kernels:
        name = k["name"]
        k.update(launches=launches[name], max_abs_err=errs[name],
                 ms=times[name][0], plain_ms=times[name][1])
        if name in dot_errs:
            k["dot_max_rel_err"] = dot_errs[name]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
