"""The plain reference: CSWin-UNet's forward, its training loss and an SGD
step, in float32 PyTorch operations only.

It follows the published description (CSWin Transformer, arXiv:2107.00652,
and the CSWin-UNet code, BoloniniD/CSWin-UNet ``networks/cswin_unet.py``
``CSWinTransformer``) and shares no code with the program: the weights come in as a flat dict keyed by
the published ``state_dict`` names (``cswin_unet.stage1.0.attns.1.get_v.weight``,
...), made by ``port_bench.weights`` from the seed; the drop-path draws are
made here again from the seed.

Departures from the published code, none of which changes the function:
  * tokens stay NHWC between layers (the published code moves between
    (B, L, C) and NCHW around each convolution);
  * the CARAFE upsampler's reassembly is one ``einsum`` over the 3x3
    neighbourhood of each up-position (the published code unfolds and
    multiplies), and the tail's classifier follows its 1x1 out conv as in
    the published model.

``Numerics`` decides the precision of every product (linear layers,
convolutions, the two attention products, the reassembly): float32 with
TF32 off (``exact()``), or the control of the precision a configuration
states (``Numerics(compute_dtype)``), the precision one step below it: the
same products on rounded operands (and, in training, rounded cotangents),
accumulated in float32. For ``bfloat16``, operands in float8 e4m3 with a
per-tensor scale and cotangents in e5m2; for ``float32``, operands and
cotangents in TF32 (10 mantissa bits, as the tensor cores take float32).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to ``top``; back in ``t.dtype``."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((t / scale).to(dtype).to(t.dtype) * scale)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 ``t`` rounded to TF32: the nearest value with 10 mantissa
    bits, ties to even, worked on the bit pattern; infinities and NaNs as
    they are."""
    bits = t.contiguous().view(torch.int32)
    odd = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + odd) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t)


# The control of each precision a configuration may state (its
# ``compute_dtype``): its name, the operands' rounding, the cotangents'.
CONTROLS = {
    "bfloat16": ("fp8", lambda t: _fp8(t, torch.float8_e4m3fn, E4M3_MAX),
                 lambda g: _fp8(g, torch.float8_e5m2, E5M2_MAX)),
    "float32": ("tf32", tf32, tf32),
}


class _Operand(torch.autograd.Function):
    """A product's operand rounded by ``rnd``; its cotangent passes
    unchanged."""

    @staticmethod
    def forward(ctx, t, rnd):
        return rnd(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Cotangent(torch.autograd.Function):
    """Identity forward; a product's output cotangent rounded by ``rnd``."""

    @staticmethod
    def forward(ctx, t, rnd):
        ctx.rnd = rnd
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


class Numerics:
    """The precision of the reference's products: float32 (TF32 off while
    ``exact()`` is open), or with ``control`` a configuration's
    ``compute_dtype`` the control of that precision (``CONTROLS``; its name
    in ``low``)."""

    def __init__(self, control: str | None = None):
        if control is not None and control not in CONTROLS:
            raise ValueError(f"no control for compute_dtype {control!r}")
        self.low, self._operand, self._cotangent = CONTROLS[control] if control else (None,) * 3

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(t, self._operand) if self.low else t

    def out(self, t: torch.Tensor) -> torch.Tensor:
        return _Cotangent.apply(t, self._cotangent) if self.low and t.requires_grad else t

    def linear(self, x, w, b=None):
        y = self.out(self.op(x) @ self.op(w).t())
        return y if b is None else y + b

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        """NCHW convolution."""
        y = self.out(F.conv2d(self.op(x), self.op(w), None, stride, padding, 1, groups))
        return y if b is None else y + b[None, :, None, None]

    def matmul(self, a, b):
        return self.out(self.op(a) @ self.op(b))

    def einsum(self, eq, a, b):
        return self.out(torch.einsum(eq, self.op(a), self.op(b)))

    @contextlib.contextmanager
    def exact(self):
        """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------------------
# Geometry and parameters


def stages(cfg: dict) -> list[dict]:
    """Each stage's resolution, width, heads, stripe width, depth and
    whether it is the last (full-window) stage."""
    ed, img = cfg["embed_dim"], cfg["img_size"]
    out = []
    for s in range(4):
        reso, split = img // (4 * 2 ** s), cfg["split_size"][s]
        out.append(dict(reso=reso, dim=ed * 2 ** s, heads=cfg["num_heads"][s],
                        split=split, depth=cfg["depths"][s],
                        last=s == 3 or reso == split))
    return out


def drop_path_rates(cfg: dict, rate: float) -> list[list[float]]:
    """The stochastic-depth rate of each block of each stage: a linear
    schedule from 0 to ``rate`` over the encoder's blocks, which the
    decoder's stage of the same index repeats."""
    depths = cfg["depths"]
    dpr = np.linspace(0, rate, sum(depths))
    offs = [sum(depths[:s]) for s in range(4)]
    return [[float(dpr[offs[s] + i]) for i in range(depths[s])] for s in range(4)]


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in the published names. Kinds:
    ``linear`` (a linear weight), ``zero`` (a linear's bias, a LayerNorm's
    bias), ``ones`` (a LayerNorm's weight), ``conv:<fan_in>`` (a
    convolution's weight or bias)."""
    ed, nc, mlp = cfg["embed_dim"], cfg["num_classes"], cfg["mlp_ratio"]
    spec: list[tuple[str, tuple, str]] = []
    p = "cswin_unet."

    def ln(name, c):
        spec.extend([(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zero")])

    def lin(name, cin, cout, bias=True):
        spec.append((f"{name}.weight", (cout, cin), "linear"))
        if bias:
            spec.append((f"{name}.bias", (cout,), "zero"))

    def conv(name, cin, cout, k, groups=1, bias=True):
        fan = f"conv:{cin // groups * k * k}"
        spec.append((f"{name}.weight", (cout, cin // groups, k, k), fan))
        if bias:
            spec.append((f"{name}.bias", (cout,), fan))

    def block(name, g):
        c = g["dim"]
        ln(f"{name}.norm1", c)
        lin(f"{name}.qkv", c, 3 * c)
        cb = c if g["last"] else c // 2
        for i in range(1 if g["last"] else 2):
            conv(f"{name}.attns.{i}.get_v", cb, cb, 3, groups=cb)
        lin(f"{name}.proj", c, c)
        ln(f"{name}.norm2", c)
        lin(f"{name}.mlp.fc1", c, int(c * mlp))
        lin(f"{name}.mlp.fc2", int(c * mlp), c)

    def carafe(name, c, c_out, up):
        conv(f"{name}.down", c, c // 4, 1)
        conv(f"{name}.encoder", c // 4, 9 * up * up, 3)
        conv(f"{name}.out", c, c_out, 1)

    geo = stages(cfg)
    conv(f"{p}stage1_conv_embed.0", cfg["in_chans"], ed, 7)
    ln(f"{p}stage1_conv_embed.2", ed)
    for s, g in enumerate(geo):
        for i in range(g["depth"]):
            block(f"{p}stage{s + 1}.{i}", g)
        if s < 3:
            conv(f"{p}merge{s + 1}.conv", g["dim"], geo[s + 1]["dim"], 3)
            ln(f"{p}merge{s + 1}.norm", geo[s + 1]["dim"])
    ln(f"{p}norm", geo[3]["dim"])
    for s in range(3, -1, -1):
        g = geo[s]
        for i in range(g["depth"]):
            block(f"{p}stage_up{s + 1}.{i}", g)
        if s > 0:
            carafe(f"{p}upsample{s + 1}", g["dim"], geo[s - 1]["dim"], 2)
            lin(f"{p}concat_linear{s + 1}", 2 * geo[s - 1]["dim"], geo[s - 1]["dim"])
    ln(f"{p}norm_up", ed)
    carafe(f"{p}upsample1", ed, ed, 4)
    conv(f"{p}output", ed, nc, 1, bias=False)
    return spec


# ---------------------------------------------------------------------------
# Forward


def _windows(t: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B·H/hs·W/ws, hs·ws, C), windows row-major."""
    B, H, W, C = t.shape
    t = t.reshape(B, H // hs, hs, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, hs * ws, C)


def _unwindows(t: torch.Tensor, hs: int, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = t.shape[-1]
    t = t.reshape(B, H // hs, W // ws, hs, ws, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, H, W, C)


def _stripe_branch(num: Numerics, q, k, v, lw, lb, hs, ws, heads, scale):
    """One CSWin stripe branch with LePE: per-head softmax(Q·Kᵀ·scale)·V in
    each hs x ws window, plus a depthwise 3x3 conv of V zero-padded at the
    window's borders."""
    B, H, W, C = q.shape
    d = C // heads

    def split_heads(t):
        return _windows(t, hs, ws).reshape(-1, hs * ws, heads, d).transpose(1, 2)

    qw, kw, vw = split_heads(q), split_heads(k), split_heads(v)
    attn = torch.softmax(num.matmul(qw * scale, kw.transpose(-1, -2)), dim=-1)
    out = num.matmul(attn, vw)                                   # (N, heads, L, d)
    v_img = _windows(v, hs, ws).reshape(-1, hs, ws, C).permute(0, 3, 1, 2)
    lepe = num.conv(v_img, lw, lb, padding=1, groups=C)          # (N, C, hs, ws)
    lepe = lepe.reshape(-1, heads, d, hs * ws).transpose(-1, -2)
    out = (out + lepe).transpose(1, 2).reshape(-1, hs * ws, C)
    return _unwindows(out, hs, ws, B, H, W)


def _block(num: Numerics, w: dict, name: str, x, g, dp=None):
    """One CSWin block: x + attn(LN(x)) ; x + MLP(LN(x)), drop-path ``dp``
    (the per-sample (keep0, keep1) multipliers, or None)."""
    B, H, W, C = x.shape
    heads, scale = g["heads"], (C // g["heads"]) ** -0.5
    y = F.layer_norm(x, (C,), w[f"{name}.norm1.weight"], w[f"{name}.norm1.bias"], 1e-5)
    qkv = num.linear(y, w[f"{name}.qkv.weight"], w[f"{name}.qkv.bias"])
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lepe = lambda i: (w[f"{name}.attns.{i}.get_v.weight"], w[f"{name}.attns.{i}.get_v.bias"])
    if g["last"]:
        att = _stripe_branch(num, q, k, v, *lepe(0), H, W, heads, scale)
    else:
        h, sp = C // 2, g["split"]
        a0 = _stripe_branch(num, q[..., :h], k[..., :h], v[..., :h], *lepe(0), H, sp,
                            heads // 2, scale)
        a1 = _stripe_branch(num, q[..., h:], k[..., h:], v[..., h:], *lepe(1), sp, W,
                            heads // 2, scale)
        att = torch.cat([a0, a1], dim=-1)
    att = num.linear(att, w[f"{name}.proj.weight"], w[f"{name}.proj.bias"])
    if dp is not None:
        att = att * dp[0][:, None, None, None]
    x = x + att
    y = F.layer_norm(x, (C,), w[f"{name}.norm2.weight"], w[f"{name}.norm2.bias"], 1e-5)
    y = F.gelu(num.linear(y, w[f"{name}.mlp.fc1.weight"], w[f"{name}.mlp.fc1.bias"]))
    y = num.linear(y, w[f"{name}.mlp.fc2.weight"], w[f"{name}.mlp.fc2.bias"])
    if dp is not None:
        y = y * dp[1][:, None, None, None]
    return x + y


def _carafe(num: Numerics, w: dict, name: str, x: torch.Tensor, up: int) -> torch.Tensor:
    """CARAFE (Wang et al., ICCV 2019), NHWC in and out: kernels predicted by
    a 1x1 compressor and a 3x3 encoder, pixel-shuffled, softmax over the 9
    taps; each up-position reassembles the 3x3 neighbourhood of its source
    pixel; then the 1x1 out conv."""
    B, H, W, C = x.shape
    xc = x.permute(0, 3, 1, 2)
    kern = num.conv(num.conv(xc, w[f"{name}.down.weight"], w[f"{name}.down.bias"]),
                    w[f"{name}.encoder.weight"], w[f"{name}.encoder.bias"], padding=1)
    kern = torch.softmax(F.pixel_shuffle(kern, up), dim=1)       # (B, 9, H·up, W·up)
    patches = F.unfold(xc, 3, padding=1).reshape(B, C, 9, H, W)
    patches = patches.repeat_interleave(up, dim=3).repeat_interleave(up, dim=4)
    out = num.einsum("bckp,bkp->bcp", patches.reshape(B, C, 9, -1),
                     kern.reshape(B, 9, -1)).reshape(B, C, H * up, W * up)
    out = num.conv(out, w[f"{name}.out.weight"], w[f"{name}.out.bias"])
    return out.permute(0, 2, 3, 1)


def forward(num: Numerics, w: dict, cfg: dict, image: torch.Tensor,
            dps: dict | None = None) -> torch.Tensor:
    """Logits (B, H, W, num_classes), float32, of (B, H, W, 1) slices.
    ``dps``: the drop-path multipliers by block name (``draw_drop_path``)."""
    p = "cswin_unet."
    geo = stages(cfg)
    x = image.expand(*image.shape[:-1], cfg["in_chans"]).permute(0, 3, 1, 2)
    x = num.conv(x, w[f"{p}stage1_conv_embed.0.weight"], w[f"{p}stage1_conv_embed.0.bias"],
                 stride=4, padding=2).permute(0, 2, 3, 1)
    x = F.layer_norm(x, (x.shape[-1],), w[f"{p}stage1_conv_embed.2.weight"],
                     w[f"{p}stage1_conv_embed.2.bias"], 1e-5)
    dps = dps or {}
    skips = []
    for s, g in enumerate(geo):
        for i in range(g["depth"]):
            name = f"{p}stage{s + 1}.{i}"
            x = _block(num, w, name, x, g, dps.get(name))
        if s < 3:
            skips.append(x)
            y = num.conv(x.permute(0, 3, 1, 2), w[f"{p}merge{s + 1}.conv.weight"],
                         w[f"{p}merge{s + 1}.conv.bias"], stride=2, padding=1)
            x = F.layer_norm(y.permute(0, 2, 3, 1), (y.shape[1],),
                             w[f"{p}merge{s + 1}.norm.weight"],
                             w[f"{p}merge{s + 1}.norm.bias"], 1e-5)
    x = F.layer_norm(x, (x.shape[-1],), w[f"{p}norm.weight"], w[f"{p}norm.bias"], 1e-5)
    for s in range(3, -1, -1):
        g = geo[s]
        for i in range(g["depth"]):
            name = f"{p}stage_up{s + 1}.{i}"
            x = _block(num, w, name, x, g, dps.get(name))
        if s > 0:
            x = _carafe(num, w, f"{p}upsample{s + 1}", x, 2)
            x = torch.cat([skips[s - 1], x], dim=-1)
            x = num.linear(x, w[f"{p}concat_linear{s + 1}.weight"],
                           w[f"{p}concat_linear{s + 1}.bias"])
    x = F.layer_norm(x, (x.shape[-1],), w[f"{p}norm_up.weight"], w[f"{p}norm_up.bias"], 1e-5)
    x = _carafe(num, w, f"{p}upsample1", x, 4)
    logits = num.conv(x.permute(0, 3, 1, 2), w[f"{p}output.weight"])
    return logits.permute(0, 2, 3, 1)


def draw_drop_path(cfg: dict, rate: float, batch: int, generator: torch.Generator) -> dict:
    """One step's drop-path multipliers, keyed by block name: each block of
    rate p > 0, in forward order (encoder stages 1-4, then decoder stages
    4-1), draws U[0, 1) of shape (2, batch) from ``generator``; a sample is
    kept where u < 1 − p and then scaled by 1 / (1 − p). Blocks of rate 0
    draw nothing."""
    rates = drop_path_rates(cfg, rate)
    order = ([f"stage{s + 1}" for s in range(4)]
             + [f"stage_up{s + 1}" for s in range(3, -1, -1)])
    out = {}
    for prefix in order:
        s = int(prefix[-1]) - 1
        for i, r in enumerate(rates[s]):
            if r <= 0:
                continue
            keep = 1.0 - r
            u = torch.rand((2, batch), generator=generator, device=generator.device)
            out[f"cswin_unet.{prefix}.{i}"] = (u < keep).float() / keep
    return out


# ---------------------------------------------------------------------------
# Training: 0.4·CE + 0.6·Dice and SGD with momentum, weight decay, poly LR


def dice_sums(logits: torch.Tensor, labels: torch.Tensor, num_classes: int):
    """Per class: Σ p·q, Σ p², Σ q over batch and pixels (p the softmax,
    q the one-hot label)."""
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    axes = tuple(range(probs.ndim - 1))
    return ((probs * onehot).sum(axes), (probs * probs).sum(axes), onehot.sum(axes))


def dice_loss(inter, z, y, num_classes: int) -> torch.Tensor:
    """Soft Dice averaged over all classes, background included, ε = 1e-5."""
    return (1.0 - (2.0 * inter + 1e-5) / (z + y + 1e-5)).sum() / num_classes


def poly_lr(step: int, base_lr: float, max_iterations: int, power: float = 0.9) -> float:
    return base_lr * min(max(1.0 - step / max_iterations, 0.0), 1.0) ** power


def train_step(num: Numerics, w: dict, cfg: dict, image, label, dps: dict, *,
               rows: int) -> tuple[float, dict]:
    """The loss 0.4·CE + 0.6·Dice of the whole batch and its gradient by
    leaf, computed ``rows`` samples at a time: a first pass without
    gradients sums the Dice terms over the batch, then each block of rows
    back-propagates its share of the CE mean and, through the Dice's
    derivatives at the batch's sums, its share of the Dice. The sum of the
    blocks' gradients is the batch's."""
    nc, B = cfg["num_classes"], image.shape[0]
    with torch.no_grad():
        sums = [torch.zeros(nc, device=image.device) for _ in range(3)]
        for r0 in range(0, B, rows):
            sl = slice(r0, r0 + rows)
            part = dice_sums(forward(num, w, cfg, image[sl], _rows(dps, sl)), label[sl], nc)
            sums = [a + b for a, b in zip(sums, part)]
    totals = [t.clone().requires_grad_() for t in sums]
    dice = dice_loss(*totals, nc)
    d_sums = torch.autograd.grad(dice, totals)
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    ce_total = 0.0
    for r0 in range(0, B, rows):
        sl = slice(r0, r0 + rows)
        logits = forward(num, leaves, cfg, image[sl], _rows(dps, sl))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, label[sl].long()[..., None]).sum()
        part = dice_sums(logits, label[sl], nc)
        share = 0.4 * nll / label.numel() + 0.6 * sum(
            (d * t).sum() for d, t in zip(d_sums, part))
        for k, g in zip(leaves, torch.autograd.grad(share, list(leaves.values()))):
            grads[k] += g
        ce_total += float(nll.detach())
    loss = 0.4 * ce_total / label.numel() + 0.6 * float(dice.detach())
    return loss, grads


def _rows(dps: dict, sl: slice) -> dict:
    return {k: v[:, sl] for k, v in dps.items()}


def sgd_update(w: dict, grads: dict, momentum: dict, lr: float, *, mu: float,
               weight_decay: float) -> None:
    """In place: d = g + wd·p; buf = d on the first step, else mu·buf + d;
    p -= lr·buf (PyTorch's SGD without dampening or Nesterov)."""
    for k, p in w.items():
        d = grads[k] + weight_decay * p
        if k in momentum:
            momentum[k].mul_(mu).add_(d)
        else:
            momentum[k] = d.clone()
        p.sub_(lr * momentum[k])

