"""Time one tree's norm forward and pair-bias forward kernels on the card.

    python3 apex_tpu_torch/tools/norm_pb_compare.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` or a ``git archive`` of
another commit, unpacked under ``build/``).  Each runs in a process of its
own, in the order given (give parent, change, change, parent to compare two
commits on one card), with that tree's ``apex_tpu_torch`` on the path and
its kernels built from its own ``csrc``.  Each prints one JSON line:

- the norm forward at the paths' shapes, bf16 with a bf16 weight: RMSNorm
  at h 2048 for n 8 (a decode step), 512 (a prefill chunk) and 8192 (the
  evaluation forward), with ``F.rms_norm`` beside it; LayerNorm with a bf16
  bias at GPT-2-large's n 8192 x h 1280 and OpenFold's m (131,072 x 256)
  and z (1,048,576 x 128), with ``F.layer_norm`` beside it;
- the pair-bias forward at OpenFold's main shape (R 128, h 8, s 1024, d 32,
  bf16, q/k/v strided views of ``[R, s, h, d]``, 10% of the keys masked),
  with SDPA beside it (the bias tiled over the rows plus the mask fill as
  one ``[R, h, s, s]`` bf16 ``attn_mask``);

each call's device ms (a CUDA graph of 20 calls, three readings), with the
card's name and power limit.
"""

import json
import os
import subprocess
import sys

from flash_bwd_compare import _device_ms

NORM = (("rms", 8, 2048), ("rms", 512, 2048), ("rms", 8192, 2048),
        ("layer_norm", 8192, 1280), ("layer_norm", 131072, 256),
        ("layer_norm", 1048576, 128))
PAIR_BIAS = dict(R=128, h=8, s=1024, d=32, mask_rate=0.1)


def measure(root: str) -> dict:
    """The readings of the tree at ``root`` (run in a fresh process)."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import pair_bias_attention as pb

    if not ln.__file__.startswith(root):
        raise RuntimeError(f"imported {ln.__file__}, not the tree at {root}")
    _build.build_all(["layer_norm_fwd.cu", "pair_bias_attention_fwd.cu"])
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"root": root, "nvidia_smi": smi}
    g = torch.Generator(device=dev).manual_seed(15)
    with torch.inference_mode():
        for norm, n, h in NORM:
            x = torch.randn(n, h, generator=g, device=dev).to(torch.bfloat16)
            w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(torch.bfloat16)
            if norm == "rms":
                fn = lambda: ln.layer_norm_fwd(x, w, None, 1e-5, True)
                lib = lambda: F.rms_norm(x, (h,), w, 1e-5)
            else:
                b = (0.1 * torch.randn(h, generator=g, device=dev)).to(torch.bfloat16)
                fn = lambda: ln.layer_norm_fwd(x, w, b, 1e-5, False)
                lib = lambda: F.layer_norm(x, (h,), w, b, 1e-5)
            out[f"{norm}_n{n}_h{h}"] = {
                "ms": [_device_ms(fn) for _ in range(3)],
                "library_ms": [_device_ms(lib) for _ in range(2)]}
        c = PAIR_BIAS
        R, h, s, d = c["R"], c["h"], c["s"], c["d"]
        q, k, v = (torch.randn(R, s, h, d, generator=g, device=dev)
                   .mul(0.5).to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        bias = (torch.randn(1, h, s, s, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        mask = torch.rand(R, s, generator=g, device=dev) >= c["mask_rate"]
        fn = lambda: pb.pair_bias_flash_attention_fwd(q, k, v, bias, mask)
        fill = torch.zeros(R, 1, 1, s, device=dev).masked_fill(
            ~mask[:, None, None, :], float("-inf"))
        am = (bias.float().repeat(R, 1, 1, 1) + fill).to(torch.bfloat16)
        del fill
        out["pair_bias_fwd"] = {
            "ms": [_device_ms(fn) for _ in range(3)],
            "sdpa_ms": [_device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=am, scale=1.0), iters=5) for _ in range(2)]}
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(measure(os.path.abspath(argv[2]))), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                               root], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
