"""Time the grouped ``mt_lamb`` at GPT-2-large's list under each group
budget, with and without its L2 hints, beside the designs it was chosen
over and two probes, in turns on the card.

    python3 apex_tpu_torch/tools/lamb_variants.py [--dry]

Source variants, ``csrc/multi_tensor.cu`` and ``csrc/multi_tensor_apply.cuh``
with a line or two replaced (``SOURCES`` below):

- ``final``: the sources as they are;
- ``no_hints``: every L2 policy ``evict_normal`` and no ``evict_last``
  prefetch (the stores as plain ones, nothing kept);
- ``divisions``: the plain version's divisions by clip, bc1 and bc2 in
  place of the reciprocals taken once a launch (four IEEE divisions an
  element and stage, as the first design);
- ``two_blocks_of_256``: two blocks of 256 threads an SM, from different
  teams, in place of one of 512 (so one block's barrier wait is the
  other's turn on the SM);
- ``ring_of_two`` / ``ring_of_four``: a ring of two (four) stages, one
  (three) rounds in flight, not two (four stages fit GPT-2-large's lists'
  six chunks a vector, not an all-fp32 list's eight);
- ``arith_cut``: a probe: stage 2's moments and update cut to a few
  multiply-adds (wrong results, kept finite), so the time left is stage
  1's, the bytes' and the barriers';
- ``no_barrier_wait``: a probe: no block waits at the grid barrier and
  stage 2 takes ratio 1 (wrong results, kept finite), so the time left is
  the stages' without the barriers.

Each runs under every budget of ``BUDGETS`` (``ops/multi_tensor.py``
``LAMB_BUDGET`` set before the table is built; all but ``final`` and
``no_hints`` at the final budget only), ``final`` also with the grid cut
into each count of ``TEAMS`` (``LAMB_TEAMS``), at GPT-2-large's O2 list
(``chip_smoke.mt_param_lists``: 436 tensors, 774 M elements; bf16
matrices, fp32 vectors, bf16 moments) with the flagship's
hyperparameters, in turns (every variant, then every variant in
reverse).  Prints one JSON object: per variant and budget the device ms
(10 eager calls between CUDA events, each reading from the same starting
state), the least reading, the plan's groups (and how many are wide),
the grid, the DRAM-byte floor of that budget beside the 14-byte roofline
(3.35 TB/s), and the max abs difference of p, m and v from the plain
version after one step from the same state; the final source without the
trust ratio (stage 2 alone: one pass, no barrier); beside them
``nvidia-smi``'s name and power limit and the kernels' registers and
spills (``-Xptxas -v``).  ``--dry`` only checks that every replacement
applies.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = "multi_tensor.cu"
HDR = "multi_tensor_apply.cuh"
MB = 1 << 20
BUDGETS = (0, 8 * MB, 16 * MB, 24 * MB, 32 * MB, 40 * MB)
TEAMS = (1, 2, 4, 6, 12)
SOURCES = {
    "no_hints": [
        (HDR, "createpolicy.fractional.L2::evict_last.b64 %0, 1.0;",
         "createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"),
        (HDR, "createpolicy.fractional.L2::evict_first.b64 %0, 1.0;",
         "createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"),
        (HDR, '  asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(p) : "memory");',
         "  (void)p;")],
    "arith_cut": [
        (SRC, "          if (recompute) lamb_moments(g[e], p[e], m[e], v[e], a, s);\n"
              "          const float u2 = lamb_update(p[e], m[e], v[e], a, s);",
         "          if (recompute) {\n"
         "            m[e] = fmaf(m[e], a.beta1, g[e]);\n"
         "            v[e] = fmaf(g[e], g[e], v[e] * a.beta2);\n"
         "          }\n"
         "          const float u2 = m[e] * v[e];")],
    "no_barrier_wait": [
        (SRC, "        while (ld_acquire(bar + 2 * wi + 1) == 0u) __nanosleep(32);",
         "        ;"),
        (SRC, "                  r, lr * (r ? __ldcg(ratios + t) : 1.f), stream, a, s);",
         "                  r, lr, stream, a, s);")],
    "two_blocks_of_256": [
        (SRC, "constexpr int kLambThreads = 512;", "constexpr int kLambThreads = 256;"),
        (SRC, "__global__ void __launch_bounds__(kLambThreads, 1)\nmt_lamb_kernel(",
         "__global__ void __launch_bounds__(kLambThreads, 2)\nmt_lamb_kernel(")],
    "ring_of_two": [
        (SRC, "constexpr int kLambRing = 3;", "constexpr int kLambRing = 2;")],
    "ring_of_four": [
        (SRC, "constexpr int kLambRing = 3;", "constexpr int kLambRing = 4;")],
    "divisions": [
        (SRC, "  float inv, rclip, rbc1, rbc2;\n};",
         "  float inv, rclip, rbc1, rbc2, clip, bc1, bc2;\n};"),
        (SRC, "  g = __fmul_rn(__fmul_rn(g, s.inv), s.rclip);",
         "  g = __fdiv_rn(__fmul_rn(g, s.inv), s.clip);"),
        (SRC, "  float u = __fdiv_rn(__fmul_rn(m, s.rbc1),\n"
              "                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.rbc2)), a.eps));",
         "  float u = __fdiv_rn(__fdiv_rn(m, s.bc1),\n"
         "                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), a.eps));"),
        (SRC, "                     a.bc1 ? __frcp_rn(*a.bc1) : 1.f, a.bc2 ? __frcp_rn(*a.bc2) : 1.f};",
         "                     a.bc1 ? __frcp_rn(*a.bc1) : 1.f, a.bc2 ? __frcp_rn(*a.bc2) : 1.f,\n"
         "                     a.clip ? *a.clip : 1.f, a.bc1 ? *a.bc1 : 1.f, a.bc2 ? *a.bc2 : 1.f};")],
}
AT_FINAL_BUDGET_ONLY = ("arith_cut", "divisions", "two_blocks_of_256",
                        "ring_of_two", "ring_of_four", "no_barrier_wait")


def _sources() -> dict:
    csrc = ROOT / "apex_tpu_torch" / "csrc"
    base = {f: (csrc / f).read_text() for f in (SRC, HDR)}
    out = {"final": dict(base)}
    for name, edits in SOURCES.items():
        texts = dict(base)
        for f, old, new in edits:
            if old not in texts[f]:
                raise SystemExit(f"{name}: {old!r} not in {f}")
            texts[f] = texts[f].replace(old, new)
        out[name] = texts
    return out


def _build_all(sources: dict) -> tuple:
    """One nvcc a variant, all started together; the final source's
    -Xptxas -v lines come back beside the libraries."""
    from apex_tpu_torch.ops import _build

    out = ROOT / "build" / "lamb_variants"
    jobs = {}
    for name, texts in sources.items():
        csrc = out / name
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC, csrc)
        for f, text in texts.items():
            (csrc / f).write_text(text)
        lib = out / f"{name}.so"
        flags = ["-Xptxas", "-v"] if name == "final" else []
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(csrc / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, []
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        if name == "final":
            ptxas = [l.strip() for l in log.splitlines()
                     if "registers" in l or "spill" in l
                     or "Compiling entry" in l]
        libs[name] = ctypes.CDLL(str(lib))
    return libs, ptxas


def main(argv) -> int:
    sources = _sources()
    if "--dry" in argv:
        print(json.dumps({"sources": sorted(sources),
                          "budgets": list(BUDGETS), "teams": list(TEAMS)}))
        return 0
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import multi_tensor as mt

    libs, ptxas = _build_all(sources)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build._LIBS[SRC] = libs["final"]
    out = {"nvidia_smi": chip_smoke.nvidia_smi("name,power.limit"),
           "ptxas": ptxas,
           "resident_blocks": mt.resident_blocks(), "ms": {}, "groups": {},
           "grid": {},
           "floor_ms": {}, "max_abs_diff": {}}
    spec = chip_smoke.mt_param_lists()["gpt2_large"]
    gen = torch.Generator(device=dev).manual_seed(73)
    with torch.no_grad():
        p = chip_smoke._mt_list_tensors(spec, gen, dev)
        g = chip_smoke._mt_list_tensors(spec, gen, dev, 0.01)
        m = chip_smoke._mt_list_tensors(spec, gen, dev, 1e-3, dtype="bfloat16")
        v = chip_smoke._mt_list_tensors(spec, gen, dev, 1e-5, positive=True,
                                        dtype="bfloat16")
    sizes = [t.numel() for t in p]
    elements = sum(sizes)
    out["roofline_ms"] = 14 * elements / 3.35e12 * 1e3
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=0.01, adam_w_mode=True, use_ratio=True,
              inv_scale=None, clip=torch.tensor(1.3, device=dev),
              bc1=torch.tensor(0.19, device=dev),
              bc2=torch.tensor(0.002, device=dev), noop=None)
    with torch.no_grad():
        start = [[t.clone() for t in lst] for lst in (p, m, v)]
        ref = [[t.clone() for t in lst] for lst in start]
        mt._plain_lamb(g, *ref, None, **kw)
    final_budget, final_teams = mt.LAMB_BUDGET, mt.LAMB_TEAMS
    runs = [(name, b, final_teams) for name in sources for b in BUDGETS
            if name not in AT_FINAL_BUDGET_ONLY or b == final_budget]
    if final_budget not in BUDGETS:
        runs += [("final", final_budget, final_teams)]
    runs += [("final", final_budget, k) for k in TEAMS if k != final_teams]
    for name, budget, teams in runs + runs[::-1]:
        key = f"{name}@{budget // MB}MB"
        if teams != final_teams:
            key += f"/{teams}teams"
        _build._LIBS[SRC] = libs[name]
        mt.LAMB_BUDGET, mt.LAMB_TEAMS = budget, teams
        mt._TABLES.clear()
        mt._BLOCKS.clear()     # a variant's occupancy may differ
        with torch.no_grad():
            if key not in out["max_abs_diff"]:
                state = [[t.clone() for t in lst] for lst in start]
                mt._kernel_lamb(g, *state, None, **kw)
                torch.cuda.synchronize()
                out["max_abs_diff"][key] = None if name in (
                    "arith_cut", "no_barrier_wait") else max(
                    float((a.float() - r.float()).abs().max())
                    for lst, rl in zip(state, ref) for a, r in zip(lst, rl))
                del state
                plan, _, grid = mt.lamb_list_plan([g, p, m, v], budget)
                out["grid"][key] = [grid, plan.teams]
                out["groups"][key] = [len(plan.groups), plan.wide]
                out["floor_ms"][key] = chip_smoke.mt_lamb_floor_ms(
                    [g, p, m, v], budget, (p, m, v))
            # every reading from the same state (a probe's garbage would
            # send the next variant's divisions down their slow path)
            for lst, src in zip((p, m, v), start):
                for t, s0 in zip(lst, src):
                    t.copy_(s0)
            ms = chip_smoke.time_ms(lambda: mt._kernel_lamb(g, p, m, v, None, **kw),
                                    iters=10, warmup=2)
        out["ms"].setdefault(key, []).append(ms)
    mt.LAMB_BUDGET, mt.LAMB_TEAMS = final_budget, final_teams
    _build._LIBS[SRC] = libs["final"]
    mt._TABLES.clear()
    mt._BLOCKS.clear()
    # one pass: without the trust ratio mt_lamb runs stage 2 alone (14
    # bytes an element, no barrier), the rate of the walk itself
    with torch.no_grad():
        one_pass = dict(kw, use_ratio=False)
        for lst, src in zip((p, m, v), start):
            for t, s0 in zip(lst, src):
                t.copy_(s0)
        out["one_pass_ms"] = chip_smoke.time_ms(
            lambda: mt._kernel_lamb(g, p, m, v, None, **one_pass),
            iters=10, warmup=2)
    out["best_ms"] = {k: min(v) for k, v in out["ms"].items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
