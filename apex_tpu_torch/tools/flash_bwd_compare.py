"""Time one tree's flash attention backward kernels on the card.

    python3 apex_tpu_torch/tools/flash_bwd_compare.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` or a ``git archive`` of
another commit, unpacked under ``build/``).  Each runs in a process of its
own, in the order given (give parent, change, change, parent to compare two
commits on one card), with that tree's ``apex_tpu_torch`` on the path and
its kernels built from its own ``csrc``.  At Llama-1B's shape (b 4, 32
heads over 8 kv heads, s 2048, d 64) and GPT-2-large's (b 8, 20 heads, s
1024, d 64), causal, bf16, in the model's ``[s, b, heads, d]`` layout, each
prints one JSON line: dq's and dk/dv's device ms (a CUDA graph of 20
launches, three readings), the host time of one launch and of one
``flash_attention_bwd`` call (20 back to back before the card ends them),
and SDPA's backward (forward + backward minus forward, CUDA graphs of 10).
"""

import json
import os
import subprocess
import sys
import time

SHAPES = {"llama_1b": (4, 32, 8, 2048, 64), "gpt2_large": (8, 20, 20, 1024, 64)}


def _device_ms(fn, iters=20):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, n=20):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return out


def measure(root: str) -> dict:
    """The readings of the tree at ``root`` (run in a fresh process)."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not the tree at {root}")
    _build.build_all(["flash_attention_fwd.cu", "flash_attention_bwd.cu"])
    dev = torch.device("cuda", 0)
    out = {"root": root}
    for name, (b, h, hk, s, d) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(25)
        q, k, v, do = (torch.randn(s, b, n, d, generator=g, device=dev)
                       .to(torch.bfloat16).permute(1, 2, 0, 3) for n in (h, hk, hk, h))
        r = {}
        with torch.no_grad():
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
            call = fa._BwdLaunch(q, k, v, o, lse, do, None, None, True, d ** -0.5, 0.0, None)
            call.launch(fa.FLASH_ATTENTION_DQ)           # delta for dk/dv
            for kn, kern in (("dq", fa.FLASH_ATTENTION_DQ), ("dkv", fa.FLASH_ATTENTION_DKV)):
                r[kn + "_ms"] = [_device_ms(lambda kern=kern: call.launch(kern)) for _ in range(3)]
                r[kn + "_launch_host_ms"] = _host_ms(lambda kern=kern: call.launch(kern))
            r["call_host_ms"] = [_host_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, causal=True)) for _ in range(3)]
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        fwd = lambda: F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                                     enable_gqa=hk != h)
        both = lambda: torch.autograd.grad(fwd(), (qr, kr, vr), do)
        r["sdpa_backward_ms"] = _device_ms(both, 10) - _device_ms(fwd, 10)
        out[name] = r
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(measure(os.path.abspath(argv[2]))), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
