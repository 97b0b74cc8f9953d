"""Outputs of the single-block kernel chain on the GPU, for comparing two
builds of the kernels bit for bit.

    python3 cswin_unet_tpu_torch/tools/probe_chain.py --root OLD --out old.pt
    python3 cswin_unet_tpu_torch/tools/probe_chain.py --root NEW --out new.pt
    python3 cswin_unet_tpu_torch/tools/probe_chain.py --compare old.pt new.pt
    python3 cswin_unet_tpu_torch/tools/probe_chain.py --root OLD --digest ref.json

``--root`` names the checkout whose ``cswin_unet_tpu_torch`` is imported
(and whose kernels are built), so one copy of this script probes any
revision of the port. Inputs come from a seeded numpy generator, the same
in every process. Recorded at the tiny-224 stage geometries:

  * ``fused_cswin_block`` (inference: ``layernorm``, the GEMM's bias /
    residual / GELU epilogues, ``stripe_attention``) at B = 32, stages 1-4;
  * ``CSWinBlockFn`` forward and backward with drop-path at B = 24, stages
    1-3 (the training epilogues, ``gemm_dgrad`` with its operand scale and
    GELU backward, ``gemm_wgrad``, ``layernorm_bwd``,
    ``stripe_attention_bwd``);
  * ``cswin_attention`` (the ``pallas`` route's entry) per branch, B = 32;
  * ``block_pair`` (two blocks in one cooperative launch) at stages 2 and 3,
    B = 32;
  * the three CARAFE sites through their public entries (the padded GEMM
    and ``carafe_reassemble``): ``carafe_up`` at (32, 28, 28, 128), and
    ``carafe_tail`` logits and ``carafe_tail_argmax`` labels at (32, 56,
    56, 64);
  * ``layernorm_bwd`` with a residual at every width it has an instance
    for (C = 32, 64, ..., 512 and 768: tiny-224's last stage and base-384's
    four among them), 3456 rows (base-384's last stage at B = 24): the
    backward is compiled once a width, and the training probes above reach
    only tiny-224's stages 1-3.

``--compare`` prints each tensor's max abs difference and exits non-zero
unless every one is 0.

Without a second checkout on hand (``chip_smoke.py`` runs from one), a build
is held to another through digests: ``--digest OUT.json`` writes each
tensor's SHA-256 (of its dtype, shape and bytes); ``chip_smoke.py`` holds
its own build's to ``REFERENCE`` (``check``). A change that is meant to
move a probed tensor's bits regenerates ``REFERENCE`` with ``--digest``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

# Digests of the probe's tensors from the build of the LayerNorm forward
# row on lane groups of 16-byte vectors (layernorm_row.cuh), beside the
# one-launch LayerNorm backward, the tensor-core CARAFE kernel, weight
# gradient, attention backward, attention and GEMM tiles, on an NVIDIA H100
# 80GB HBM3.
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probe_reference.json")

# stage, H, C, heads, split, last (tiny-224)
STAGES = ((1, 56, 64, 2, 1, False), (2, 28, 128, 4, 2, False),
          (3, 14, 256, 8, 7, False), (4, 7, 512, 16, 7, True))


def probe(dev) -> dict:
    import torch

    from cswin_unet_tpu_torch.ops.cuda import carafe_tail as CT
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import BlockParams, fused_cswin_block

    rng = np.random.default_rng(20)
    t = lambda *s, sc=0.1, off=0.0: torch.from_numpy(
        (rng.standard_normal(s) * sc + off).astype(np.float32)).to(dev)

    def params(C, last):
        cb = C if last else C // 2
        lk0, lb0 = t(cb, 1, 3, 3, sc=0.3), t(cb)
        lk1, lb1 = (lk0, lb0) if last else (t(cb, 1, 3, 3, sc=0.3), t(cb))
        return BlockParams(t(C, sc=0.3, off=1.0), t(C), t(3 * C, C), t(3 * C), lk0, lb0,
                           lk1, lb1, t(C, C), t(C), t(C, sc=0.3, off=1.0), t(C),
                           t(4 * C, C), t(4 * C), t(C, 4 * C), t(C))

    out = {}
    for s, H, C, heads, split, last in STAGES:
        kw = dict(heads=heads, split=split, last_stage=last, scale=(C // heads) ** -0.5)
        p = params(C, last)
        x = t(32, H, H, C, sc=1.0).bfloat16()
        with torch.inference_mode():
            out[f"block_s{s}"] = fused_cswin_block(x, p, **kw)
        cb, nh = (C, heads) if last else (C // 2, heads // 2)
        qkv = t(32, H, H, 3, C, sc=1.0).bfloat16()
        for i, (hs, ws) in enumerate([(H, H)] if last else [(H, split), (split, H)]):
            off = i * cb
            q, k, v = (qkv[..., j, off:off + cb] for j in range(3))
            out[f"cswin_attention_s{s}_{hs}x{ws}"] = K.cswin_attention(
                q, k, v, t(cb, 1, 3, 3, sc=0.3), t(cb), h_sp=hs, w_sp=ws,
                num_heads=nh, scale=kw["scale"])
        if last:
            continue
        out[f"pair_s{s}"] = K.block_pair(x, p, params(C, False), heads=heads, split=split,
                                         scale=kw["scale"])
        leaves = [t(24, H, H, C, sc=1.0).bfloat16().requires_grad_()]
        leaves += [q.clone().requires_grad_() for q in params(C, False)]
        g = t(24, H, H, C, sc=1.0).bfloat16()
        dps = tuple(torch.from_numpy((rng.random(24) < 0.8).astype(np.float32) / 0.8)
                    .to(dev) for _ in range(2))
        y = fused_cswin_block(leaves[0], BlockParams(*leaves[1:]), dps=dps, **kw)
        out[f"train_s{s}_out"] = y.detach()
        for i, gr in enumerate(torch.autograd.grad(y, leaves, g)):
            out[f"train_s{s}_grad{i}"] = gr

    def carafe_params(C, C_out, up, nc=None):
        cm = C // 4
        p = [t(cm, C, 1, 1, sc=0.2), t(cm, sc=0.2), t(9 * up * up, cm, 3, 3, sc=0.2),
             t(9 * up * up, sc=0.2), t(C_out, C, 1, 1, sc=0.2), t(C_out, sc=0.2)]
        return p + ([t(nc, C_out, 1, 1, sc=0.2)] if nc else [])

    up = carafe_params(128, 64, 2)
    tail = carafe_params(64, 64, 4, nc=9)
    x28, x56 = t(32, 28, 28, 128, sc=1.0).bfloat16(), t(32, 56, 56, 64, sc=1.0).bfloat16()
    with torch.inference_mode():
        out["carafe_up"] = CT.carafe_up(x28, *up)
        out["carafe_tail"] = CT.carafe_tail(x56, *tail)
        out["carafe_tail_argmax"] = CT.carafe_tail_argmax(x56, *tail)
    for C in (*range(32, 513, 32), 768):
        x, dy, res = (t(3456, C, sc=1.0).bfloat16() for _ in range(3))
        grads = K.layernorm_bwd(x, dy, t(C, sc=0.3, off=1.0), residual=res)
        for name, g in zip(("dx", "dweight", "dbias"), grads):
            out[f"ln_bwd_c{C}_{name}"] = g
    torch.cuda.synchronize()
    return {k: v.detach().cpu() for k, v in out.items()}


def digests(tensors: dict) -> dict[str, str]:
    """SHA-256 of each tensor's dtype, shape and bytes."""
    import torch

    out = {}
    for k, v in sorted(tensors.items()):
        h = hashlib.sha256(f"{v.dtype} {tuple(v.shape)}".encode())
        h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        out[k] = h.hexdigest()
    return out


def check(got: dict[str, str], ref_path: str = REFERENCE) -> tuple[bool, str]:
    """(equal, report) of probe digests against a reference file."""
    with open(ref_path) as f:
        want = json.load(f)["digests"]
    differ = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    report = (f"{len(want)} tensors, {len(want) - len(differ)} equal bit for bit to "
              f"{os.path.basename(ref_path)}" + (f"; different: {differ}" if differ else ""))
    return not differ, report


def compare(a: str, b: str) -> int:
    import torch

    ta, tb = torch.load(a), torch.load(b)
    if set(ta) != set(tb):
        print(f"[probe] different tensors: {sorted(set(ta) ^ set(tb))}")
        return 1
    worst = 0.0
    for k in sorted(ta):
        same = ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape
        d = float((ta[k].double() - tb[k].double()).abs().max()) if same else float("inf")
        worst = max(worst, d)
        print(f"[probe] {k} {tuple(ta[k].shape)} {ta[k].dtype} max_abs={d:.3e}")
    print(f"[probe] {len(ta)} tensors, worst max_abs={worst:.3e}: "
          f"{'equal bit for bit' if worst == 0 else 'DIFFERENT'}")
    return 0 if worst == 0 else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose cswin_unet_tpu_torch to probe")
    ap.add_argument("--out", help="where to write the probed tensors (torch.save)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--digest", help="write the probed tensors' digests (JSON) here")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    import torch

    if not torch.cuda.is_available():
        print("probe_chain: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import cswin_unet_tpu_torch

    if not os.path.abspath(cswin_unet_tpu_torch.__file__).startswith(root + os.sep):
        print(f"probe_chain: imported {cswin_unet_tpu_torch.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tensors = probe(torch.device("cuda", 0))
    if args.out:
        torch.save(tensors, args.out)
        print(f"[probe] {root}: wrote {args.out}")
    if args.digest:
        with open(args.digest, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "digests": digests(tensors)},
                      f, indent=1)
        print(f"[probe] {root}: wrote {args.digest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
