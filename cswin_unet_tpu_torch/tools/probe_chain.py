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
    only tiny-224's stages 1-3;
  * the float32 instances (``f32_*``, TPU.COMPUTE_DTYPE float32) at the
    stage geometries of tiny-224 (B = 24, the training batch) and base-384
    (B = 2): ``gemm`` in every epilogue (bias; residual with and without
    the drop-path scale; GELU with and without the kept pre-activation; the
    dropout instances of the residual and GELU epilogues) and
    ``gemm_dgrad`` (plain, with the operand scale, with the GELU backward,
    and with both dropout masks), so that every tile the float32 planner
    picks at those shapes is reached; the float32 chain
    (``fused_cswin_block``) at B = 8 / 2, ``CSWinBlockFn``'s float32
    forward and input gradient (which no weight gradient reaches) at
    tiny-224's stages 1-3, B = 4, and ``block_pair`` at float32 at tiny-224's
    stages 2 and 3 and base-384's stage 3. The float32 weight gradient is
    not probed: its split plan sets its bits (the float64 rule holds it);
  * the float32 attention kernels directly (``f32att_*``, inputs from their
    own generator): ``stripe_attention_bwd`` (dq, dk, dv in the branch's
    channels of dqkv, and the summed LePE weight and bias partials) on both
    branches at tiny-224's stages 1-3 (B = 24) and base-384's stage 3 (B =
    2), and ``cswin_attention`` (the ``pallas`` route's entry) on both
    branches at every stage of both configs (B = 8 / 2).

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

# Digests of the probe's tensors from the build of the bf16 attention
# backward's row and key kernels (stripe_attention_bwd.cu's split route,
# windows longer than one key block: tiny-224's stage 3), beside the float32
# attention tile and backward on register blocks (attention_tile.cuh::
# tile_f32, the float32 row and key kernels), the LayerNorm
# forward row on lane groups of 16-byte vectors, the one-launch LayerNorm
# backward, the tensor-core CARAFE kernel, weight gradient, attention
# backward, attention and GEMM tiles and the float32 GEMMs, on an NVIDIA
# H100 80GB HBM3.
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probe_reference.json")

# stage, H, C, heads, split, last (tiny-224)
STAGES = ((1, 56, 64, 2, 1, False), (2, 28, 128, 4, 2, False),
          (3, 14, 256, 8, 7, False), (4, 7, 512, 16, 7, True))
# the same for base-384 (head dim 24)
STAGES384 = ((1, 96, 96, 4, 1, False), (2, 48, 192, 8, 2, False),
             (3, 24, 384, 16, 12, False), (4, 12, 768, 32, 12, True))


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
    out.update(probe_f32(dev))
    out.update(probe_f32_attention(dev))
    torch.cuda.synchronize()
    return {k: v.detach().cpu() for k, v in out.items()}


def probe_f32(dev) -> dict:
    """The float32 instances' outputs (``f32_*``): the GEMM and dX products
    in every epilogue, the float32 chain, its training forward and input
    gradient, and the float32 pair; inputs from their own seeded generator,
    so that the bf16 probes' inputs stay as they were."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import BlockParams, fused_cswin_block
    from cswin_unet_tpu_torch.ops.dropout import Drop

    rng = np.random.default_rng(21)
    t = lambda *s, sc=0.1, off=0.0: torch.from_numpy(
        (rng.standard_normal(s) * sc + off).astype(np.float32)).to(dev)
    key = lambda: torch.from_numpy(rng.integers(-2**62, 2**62, 1)).to(dev)

    def params(C, last):
        cb = C if last else C // 2
        lk0, lb0 = t(cb, 1, 3, 3, sc=0.3), t(cb)
        lk1, lb1 = (lk0, lb0) if last else (t(cb, 1, 3, 3, sc=0.3), t(cb))
        return BlockParams(t(C, sc=0.3, off=1.0), t(C), t(3 * C, C, sc=C ** -0.5), t(3 * C),
                           lk0, lb0, lk1, lb1, t(C, C, sc=C ** -0.5), t(C),
                           t(C, sc=0.3, off=1.0), t(C), t(4 * C, C, sc=C ** -0.5), t(4 * C),
                           t(C, 4 * C, sc=(4 * C) ** -0.5), t(C))

    out = {}
    for cfg, stages, B in (("tiny", STAGES, 24), ("base", STAGES384, 2)):
        for s, H, C, heads, split, last in stages:
            tag = f"f32_{cfg}_s{s}"
            M, hw = B * H * H, H * H
            x, h, res = t(M, C, sc=1.0), t(M, 4 * C, sc=1.0), t(M, C, sc=1.0)
            dp = torch.from_numpy((rng.random(B) < 0.8).astype(np.float32) / 0.8).to(dev)
            w_qkv, w_proj, w1, w2 = (t(3 * C, C, sc=C ** -0.5), t(C, C, sc=C ** -0.5),
                                     t(4 * C, C, sc=C ** -0.5), t(C, 4 * C, sc=(4 * C) ** -0.5))
            b_qkv, b_proj, b1, b2 = t(3 * C), t(C), t(4 * C), t(C)
            d1, d2 = Drop(key(), 0.1), Drop(key(), 0.1)
            pre = torch.empty(M, 4 * C, device=dev)
            pre_d = torch.empty(M, 4 * C, device=dev)
            out[f"{tag}_qkv"] = K.gemm(x, w_qkv, b_qkv)
            out[f"{tag}_proj"] = K.gemm(x, w_proj, b_proj, residual=res, epilogue="residual")
            out[f"{tag}_proj_dp"] = K.gemm(x, w_proj, b_proj, residual=res,
                                           epilogue="residual", dp=dp, rows_per_sample=hw)
            out[f"{tag}_fc1"] = K.gemm(x, w1, b1, epilogue="gelu")
            out[f"{tag}_fc1_pre"] = K.gemm(x, w1, b1, epilogue="gelu", pre=pre)
            out[f"{tag}_fc1_pre_h"] = pre
            out[f"{tag}_fc2_dp"] = K.gemm(h, w2, b2, residual=res, epilogue="residual",
                                          dp=dp, rows_per_sample=hw)
            out[f"{tag}_fc2_dp_drop"] = K.gemm(h, w2, b2, residual=res, epilogue="residual",
                                               dp=dp, rows_per_sample=hw, drop=d2)
            out[f"{tag}_fc1_pre_drop"] = K.gemm(x, w1, b1, epilogue="gelu", pre=pre_d, drop=d1)
            out[f"{tag}_fc1_pre_drop_h"] = pre_d
            out[f"{tag}_dx_fc2_gelu_dp"] = K.gemm_dgrad(res, w2, dp=dp, rows_per_sample=hw,
                                                        gelu_h=h)
            out[f"{tag}_dx_fc2_gelu_drop"] = K.gemm_dgrad(res, w2, dp=dp, rows_per_sample=hw,
                                                          gelu_h=h, drop_dy=d2, drop_dx=d1)
            out[f"{tag}_dx_fc1"] = K.gemm_dgrad(h, w1)
            out[f"{tag}_dx_proj_dp"] = K.gemm_dgrad(res, w_proj, dp=dp, rows_per_sample=hw)
            out[f"{tag}_dx_qkv"] = K.gemm_dgrad(t(M, 3 * C, sc=1.0), w_qkv)
            del h, pre, pre_d
            kw = dict(heads=heads, split=split, last_stage=last, scale=(C // heads) ** -0.5)
            p = params(C, last)
            xb = t(8 if cfg == "tiny" else 2, H, H, C, sc=1.0)
            with torch.inference_mode():
                out[f"{tag}_block"] = fused_cswin_block(xb, p, **kw)
            if last:
                continue
            if cfg == "tiny" and s < 4:
                leaves = [t(4, H, H, C, sc=1.0).requires_grad_()]
                leaves += [q.clone().requires_grad_() for q in params(C, False)]
                g = t(4, H, H, C, sc=1.0)
                dps = tuple(torch.from_numpy((rng.random(4) < 0.8).astype(np.float32) / 0.8)
                            .to(dev) for _ in range(2))
                y = fused_cswin_block(leaves[0], BlockParams(*leaves[1:]), dps=dps, **kw)
                out[f"{tag}_train_out"] = y.detach()
                out[f"{tag}_train_dx"] = torch.autograd.grad(y, leaves[0], g)[0]
            if (cfg, s) in (("tiny", 2), ("tiny", 3), ("base", 3)):
                pkw = dict(heads=heads, split=split, scale=kw["scale"])
                out[f"{tag}_pair"] = K.block_pair(xb, p, params(C, False), **pkw)
    return out


def probe_f32_attention(dev) -> dict:
    """The float32 attention backward and ``cswin_attention`` on their own
    (``f32att_*``), from their own seeded generator."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    rng = np.random.default_rng(22)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    out = {}
    for cfg, stages, B in (("tiny", STAGES, 24), ("base", STAGES384, 2)):
        for s, H, C, heads, split, last in stages:
            tag = f"f32att_{cfg}_s{s}"
            branches = ([(0, C, heads, H, H)] if last else
                        [(0, C // 2, heads // 2, H, split), (C // 2, C // 2, heads // 2, split, H)])
            scale = (C // heads) ** -0.5
            qkv = t(8 if cfg == "tiny" else 2, H, H, 3 * C)
            for n, (off, cb, nh, hs, ws) in enumerate(branches):
                q, k, v = (qkv[..., i * C + off:i * C + off + cb] for i in range(3))
                lw, lb = t(cb, 1, 3, 3, sc=0.3), t(cb, sc=0.1)
                out[f"{tag}_cswin_b{n}"] = K.cswin_attention(q, k, v, lw, lb, h_sp=hs, w_sp=ws,
                                                             num_heads=nh, scale=scale)
            if (cfg, s) not in (("tiny", 1), ("tiny", 2), ("tiny", 3), ("base", 3)):
                continue
            qkv, dout = t(B, H, H, 3 * C), t(B, H, H, C)
            for n, (off, cb, nh, hs, ws) in enumerate(branches):
                lw = t(cb, 1, 3, 3, sc=0.3)
                dqkv = torch.zeros(B, H, H, 3 * C, device=dev)
                dw, db = K.stripe_attention_bwd(qkv, dout, lw, dqkv, ch_off=off, heads=nh,
                                                h_sp=hs, w_sp=ws, scale=scale)
                chans = torch.cat([torch.arange(off, off + cb) + i * C for i in range(3)])
                out[f"{tag}_bwd_b{n}_dqkv"] = dqkv[..., chans.to(dev)]
                out[f"{tag}_bwd_b{n}_dlepe_w"] = dw
                out[f"{tag}_bwd_b{n}_dlepe_b"] = db
    return out


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
