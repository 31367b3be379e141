"""Time one tree's norm forward and backward and pair-bias attention
kernels, and with ``--openfold`` its OpenFold training step, on the card.

    python3 apex_tpu_torch/tools/norm_pb_compare.py [--openfold] ROOT [ROOT ...]

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
- the norm backward at the paths' shapes (``chip_smoke.NORM_BWD_SHAPES``'s,
  x bf16: Llama-1B's RMSNorm with an fp32 scale, GPT-2-large's LayerNorm
  with an fp32 weight and bias, OpenFold's m and z rows with bf16 ones),
  with ``F.rms_norm`` / ``F.layer_norm``'s backward (forward + backward
  minus forward, the weight and bias cast to x's dtype) beside it;
- the pair-bias forward and its dq, dk/dv and dbias kernels at OpenFold's
  main shape (R 128, h 8, s 1024, d 32, bf16, q/k/v/do strided views of
  ``[R, s, h, d]``, a bf16 bias ``[1, 8, 1024, 1024]``, 10% of the keys
  masked), with SDPA's forward and backward (forward + backward minus
  forward) beside them (the bias tiled over the rows plus the mask fill
  as one ``[R, h, s, s]`` bf16 ``attn_mask``);

each call's device ms (a CUDA graph of 20 calls, three readings; the
library's two), with the card's name and power limit.  With
``--openfold``, also the tree's own ``chip_smoke.py``'s ``openfold_train``
(four MSA-row attention blocks at the Evoformer widths, N_seq 128, N_res
1024, bf16, ``FusedAdamSWA``, 1 + 6 steps): the steps' wall and host-issue
ms, the peak memory, the launches a step, and the profiled step's device
busy ms, idle share and device ms by kind.
"""

import json
import os
import subprocess
import sys

from flash_bwd_compare import _device_ms

NORM = (("rms", 8, 2048), ("rms", 512, 2048), ("rms", 8192, 2048),
        ("layer_norm", 8192, 1280), ("layer_norm", 131072, 256),
        ("layer_norm", 1048576, 128))
# (name, n, h, rms, weight dtype): chip_smoke.NORM_BWD_SHAPES, kept here so
# that a parent tree's own chip_smoke.py need not have them
NORM_BWD = (("llama_1b", 8192, 2048, True, "float32"),
            ("gpt2_large", 8192, 1280, False, "float32"),
            ("openfold_m", 131072, 256, False, "bfloat16"),
            ("openfold_z", 1048576, 128, False, "bfloat16"))
PAIR_BIAS = dict(R=128, h=8, s=1024, d=32, mask_rate=0.1)
SOURCES = ["layer_norm_fwd.cu", "layer_norm_bwd.cu", "pair_bias_attention_fwd.cu",
           "pair_bias_attention_bwd.cu"]


def _norm(out, g, dev) -> None:
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

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


def _norm_bwd(out, g, dev) -> None:
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for name, n, h, rms, wdt in NORM_BWD:
        x = torch.randn(n, h, generator=g, device=dev).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtypes[wdt])
        b = None if rms else (0.1 * torch.randn(h, generator=g, device=dev)).to(dtypes[wdt])
        dy = torch.randn(n, h, generator=g, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            _, mean, rstd = ln.layer_norm_fwd(x, w, b, 1e-5, rms)
            fn = lambda: ln.layer_norm_bwd(dy, x, mean, rstd, w, b, rms, False)
            ms = [_device_ms(fn) for _ in range(3)]
        leaves = [x.detach().requires_grad_(), w.to(x.dtype).requires_grad_()]
        if rms:
            lib = lambda: F.rms_norm(leaves[0], (h,), leaves[1], 1e-5)
        else:
            leaves.append(b.to(x.dtype).requires_grad_())
            lib = lambda: F.layer_norm(leaves[0], (h,), leaves[1], leaves[2], 1e-5)
        both = lambda: torch.autograd.grad(lib(), leaves, dy)
        out[f"norm_bwd_{name}"] = {
            "ms": ms, "library_ms": [_device_ms(both, 10) - _device_ms(lib, 10)
                                     for _ in range(2)]}


def _pair_bias(out, g, dev) -> None:
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.ops import pair_bias_attention as pb

    c = PAIR_BIAS
    R, h, s, d = c["R"], c["h"], c["s"], c["d"]
    q, k, v, do = (torch.randn(R, s, h, d, generator=g, device=dev)
                   .mul(0.5).to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    bias = (torch.randn(1, h, s, s, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    mask = torch.rand(R, s, generator=g, device=dev) >= c["mask_rate"]
    fill = torch.zeros(R, 1, 1, s, device=dev).masked_fill(
        ~mask[:, None, None, :], float("-inf"))
    am = (bias.float().repeat(R, 1, 1, 1) + fill).to(torch.bfloat16)
    del fill
    with torch.inference_mode():
        fwd = lambda: pb.pair_bias_flash_attention_fwd(q, k, v, bias, mask)
        o, lse = fwd()
        call = pb._Launch(q, k, v, bias, mask, 1.0, o=o, lse=lse, do=do)
        call.launch(pb.PAIR_BIAS_DQ)                 # delta for the other two
        out["pair_bias_fwd"] = {
            "ms": [_device_ms(fwd) for _ in range(3)],
            "sdpa_ms": [_device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=am, scale=1.0), iters=5) for _ in range(2)]}
        for name, kern in (("dq", pb.PAIR_BIAS_DQ), ("dkv", pb.PAIR_BIAS_DKV),
                           ("dbias", pb.PAIR_BIAS_DBIAS)):
            out[f"pair_bias_{name}"] = {
                "ms": [_device_ms(lambda: call.launch(kern)) for _ in range(3)]}
    del call, o, lse
    # SDPA's backward: its forward and backward minus its forward, both
    # with inputs that need gradients (which take another kernel than the
    # forward alone)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, am)]
    sdpa = lambda: F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
    both = lambda: torch.autograd.grad(sdpa(), leaves, do)
    fwd_ms = [_device_ms(sdpa, iters=5) for _ in range(2)]
    both_ms = [_device_ms(both, iters=5) for _ in range(2)]
    out["pair_bias_bwd_sdpa_ms"] = [b - f for b, f in zip(both_ms, fwd_ms)]


def _openfold(out, dev) -> None:
    import torch

    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.py's main
    torch.backends.cudnn.allow_tf32 = False
    got = chip_smoke.openfold_train(dev)
    prof = got["profile"]
    out["openfold"] = {
        "step_ms": got["step_ms"], "step_ms_median": got["step_ms_median"],
        "step_issue_ms": got["step_issue_ms"], "peak_mem_bytes": got["peak_mem_bytes"],
        "launches_per_step": got["launches_per_step"],
        "device_busy_ms": prof["device_busy_ms"],
        "device_idle_share_unprofiled": prof["device_idle_share_unprofiled"],
        "device_ms_by_kind": prof["device_ms_by_kind"]}


def measure(root: str, openfold: bool) -> dict:
    """The readings of the tree at ``root`` (run in a fresh process)."""
    sys.path.insert(0, root)
    import torch

    from apex_tpu_torch.ops import _build

    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree at {root}")
    _build.build_all(SOURCES)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"root": root, "nvidia_smi": smi}
    g = torch.Generator(device=dev).manual_seed(15)
    with torch.inference_mode():
        _norm(out, g, dev)
    _norm_bwd(out, g, dev)
    _pair_bias(out, g, dev)
    if openfold:
        torch.cuda.empty_cache()
        _openfold(out, dev)
    return out


def main(argv) -> int:
    if len(argv) >= 3 and argv[1] == "--one":
        print(json.dumps(measure(os.path.abspath(argv[2]), "--openfold" in argv[3:])),
              flush=True)
        return 0
    flags = [a for a in argv[1:] if a == "--openfold"]
    roots = [a for a in argv[1:] if a != "--openfold"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                               root, *flags], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
