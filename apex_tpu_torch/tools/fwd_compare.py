"""Time one tree's flash attention forward and fused LM-head forward kernels
on the card.

    python3 apex_tpu_torch/tools/fwd_compare.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` or a ``git archive`` of
another commit, unpacked under ``build/``).  Each runs in a process of its
own, in the order given (give parent, change, change, parent to compare two
commits on one card), with that tree's ``apex_tpu_torch`` on the path and
its kernels built from its own ``csrc``.  Each prints one JSON line:

- the flash forward at Llama-1B's shape (b 4, 32 heads over 8 kv heads, s
  2048, d 64) and GPT-2-large's (b 8, 20 heads, s 1024, d 64), causal,
  bf16, in the model's ``[s, b, heads, d]`` layout, with SDPA beside it;
- the head forward at Llama-1B's head (T 8192, h 2048, V 32000) and
  GPT-2-large's (T 8192, h 1280, V 50257), bf16, with ``F.linear`` +
  ``F.cross_entropy`` beside it;

each kernel's device ms (a CUDA graph of 20 calls, three readings) and the
host side of one call (20 back to back before the card ends them).
"""

import json
import os
import subprocess
import sys

from flash_bwd_compare import _device_ms, _host_ms

FLASH = {"llama_1b": (4, 32, 8, 2048, 64), "gpt2_large": (8, 20, 20, 1024, 64)}
HEAD = {"llama_1b": (8192, 2048, 32000), "gpt2_large": (8192, 1280, 50257)}


def measure(root: str) -> dict:
    """The readings of the tree at ``root`` (run in a fresh process)."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh

    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not the tree at {root}")
    _build.build_all(["flash_attention_fwd.cu", "fused_lm_head_fwd.cu"])
    dev = torch.device("cuda", 0)
    out = {"root": root}
    with torch.inference_mode():
        for name, (b, h, hk, s, d) in FLASH.items():
            g = torch.Generator(device=dev).manual_seed(13)
            q, k, v = (torch.randn(s, b, n, d, generator=g, device=dev)
                       .to(torch.bfloat16).permute(1, 2, 0, 3) for n in (h, hk, hk))
            fn = lambda: fa.flash_attention_fwd(q, k, v, causal=True)
            out[f"flash_{name}"] = {
                "ms": [_device_ms(fn) for _ in range(3)],
                "call_host_ms": _host_ms(fn),
                "sdpa_ms": _device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=hk != h))}
        for name, (t, hid, vocab) in HEAD.items():
            g = torch.Generator(device=dev).manual_seed(14)
            hs = torch.randn(t, hid, generator=g, device=dev).to(torch.bfloat16)
            e = (torch.randn(vocab, hid, generator=g, device=dev) * 0.02).to(torch.bfloat16)
            lab = torch.randint(0, vocab, (t,), generator=g, device=dev)
            fn = lambda: lh.fused_lm_head_fwd(hs, e, lab)
            out[f"head_{name}"] = {
                "ms": [_device_ms(fn) for _ in range(3)],
                "call_host_ms": _host_ms(fn),
                "library_ms": _device_ms(lambda: F.cross_entropy(
                    F.linear(hs, e), lab, reduction="none"))}
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
