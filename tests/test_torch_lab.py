"""The block lab's functions against the JAX functions the TPU experiment
kernels wrap, and the lab's entry point on the CPU.

Seeded numpy inputs go through the JAX functions as the bodies of the
``scripts/exp_*.py`` kernels call them (``cb._lepe_windows`` in its shift and
0/1-matrix forms, ``cb._lepe_windows_dual``, ``cb._lepe_windows_dual_cs``
with the fold of halves, ``cb._attn_windows``, ``cb._attn_windows_hb``, and
the MLP bodies composed from ``cb._layernorm``, ``cb._dot`` and ``cb._erf``)
and through the port's ``lepe_windows``, ``window_attention`` and ``ln_mlp``,
which on CPU tensors run their plain versions. The scripts themselves are
not imported: they set a compilation-cache directory and read ``sys.argv``
at import.

Tolerances: float32 inputs, max abs error <= 1e-4 (the scripts' own parity
bound, ``exp_lepe_mm.py``); bf16 inputs, relative L2 <= 0.02 (the reference
gate's default; it covers the JAX functions' bf16 accumulation and deferred
softmax normalisation, where the port accumulates in float32 and rounds
once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cswin_unet_tpu.ops.pallas.cswin_block as cb
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.ops.windows import window_partition
from cswin_unet_tpu_torch.tools import block_lab

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (n windows, sp_h, sp_w, c): the 7x14, 2x28 and 1x56 window classes, narrow
GEOMETRIES = [(4, 7, 14, 16), (6, 2, 28, 16), (8, 1, 56, 8)]


def _agree(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64).reshape(got.shape)
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-4
    else:
        assert np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12) <= 0.02


def _pair(rng, dtype, *shape, sc=1.0):
    """The same seeded array for JAX and for torch, in ``dtype``."""
    a = (rng.standard_normal(shape) * sc).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _taps(rng, c):
    lk = (rng.standard_normal((3, 3, c)) * 0.3).astype(np.float32)
    lb = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return (jnp.asarray(lk), jnp.asarray(lb)), (torch.from_numpy(lk), torch.from_numpy(lb))


@pytest.mark.parametrize("form", ["shift", "mm"])
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("n,sp_h,sp_w,c", GEOMETRIES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lepe_windows_matches_jax(monkeypatch, dtype, n, sp_h, sp_w, c, swap, form):
    """``exp_lepe_mm.py``'s two arms (and ``exp_attn3.py::k_lepe``): one
    function, tap grid as given and transposed."""
    monkeypatch.setattr(cb, "_LEPE_MM_MODE", form)
    rng = np.random.default_rng(0)
    vj, vt = _pair(rng, dtype, n, sp_h * sp_w, c)
    (lkj, lbj), (lkt, lbt) = _taps(rng, c)
    want = cb._lepe_windows(vj.reshape(n, sp_h, sp_w, c), lkj, lbj, swap=swap)
    got = K.lepe_windows(vt, lkt, lbt, sp_h=sp_h, sp_w=sp_w, swap=swap)
    assert got.shape == vt.shape and got.dtype == vt.dtype
    _agree(got, want, dtype)


@pytest.mark.parametrize("form", ["shift", "mm"])
@pytest.mark.parametrize("n,sp_h,sp_w,c", GEOMETRIES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lepe_windows_two_tap_sets_match_jax_dual(monkeypatch, dtype, n, sp_h, sp_w, c, form):
    """``exp_mm_bisect.py`` rung f: two branches' windows stacked on the
    batch, the first with transposed taps."""
    monkeypatch.setattr(cb, "_LEPE_MM_MODE", form)
    rng = np.random.default_rng(1)
    vj, vt = _pair(rng, dtype, 2 * n, sp_h * sp_w, c)
    (lk0j, lb0j), (lk0t, lb0t) = _taps(rng, c)
    (lk1j, lb1j), (lk1t, lb1t) = _taps(rng, c)
    want = cb._lepe_windows_dual(vj.reshape(2 * n, sp_h, sp_w, c), lk0j, lb0j, lk1j, lb1j, n)
    got = K.lepe_windows(vt, lk0t, lb0t, sp_h=sp_h, sp_w=sp_w, swap=True, taps2=lk1t,
                         bias2=lb1t, n0=n)
    _agree(got, want, dtype)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("n,sp_h,sp_w,c", GEOMETRIES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lepe_windows_two_sources_match_jax_dual_cs(dtype, n, sp_h, sp_w, c, fold):
    """``exp_cs_bisect.py::k_full``: two branches stacked on channels, the
    taps merged outside (the vertical branch's transposed), and the halves
    added."""
    rng = np.random.default_rng(2)
    vaj, vat = _pair(rng, dtype, n, sp_h * sp_w, c)
    vbj, vbt = _pair(rng, dtype, n, sp_h * sp_w, c)
    (lk0j, lb0j), (lk0t, lb0t) = _taps(rng, c)
    (lk1j, lb1j), (lk1t, lb1t) = _taps(rng, c)
    lkc = jnp.concatenate([lk0j.transpose(1, 0, 2), lk1j], -1)
    lbc = jnp.concatenate([lb0j, lb1j])
    vcs = jnp.concatenate([vaj, vbj], -1).reshape(n, sp_h, sp_w, 2 * c)
    want = cb._lepe_windows_dual_cs(vcs, lkc, lbc)
    if fold:
        want = want[..., :c] + want[..., c:]
    got = K.lepe_windows(vat, torch.cat([lk0t.transpose(0, 1), lk1t], -1),
                         torch.cat([lb0t, lb1t]), sp_h=sp_h, sp_w=sp_w, v2=vbt, fold=fold)
    assert got.shape == (n, sp_h * sp_w, c if fold else 2 * c)
    _agree(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lepe_windows_layouts_agree(dtype):
    """An image batch tiled by windows, V in place as the last third of a
    packed tensor, and bf16 taps, against the contiguous window stack."""
    rng = np.random.default_rng(3)
    td = DTYPES[dtype][1]
    B, H, W, c, sp_h, sp_w = 2, 4, 14, 8, 2, 7
    qkv = torch.from_numpy(rng.standard_normal((B, H, W, 3 * c)).astype(np.float32)).to(td)
    _, (lk, lb) = _taps(rng, c)
    v = qkv[..., 2 * c:]
    on_image = K.lepe_windows(v, lk, lb, sp_h=sp_h, sp_w=sp_w)
    windows = window_partition(v.contiguous(), sp_h, sp_w)
    on_windows = K.lepe_windows(windows, lk, lb, sp_h=sp_h, sp_w=sp_w)
    assert on_image.shape == v.shape and on_image.is_contiguous()
    assert torch.equal(window_partition(on_image, sp_h, sp_w), on_windows)
    rounded = K.lepe_windows(windows, lk, lb, sp_h=sp_h, sp_w=sp_w,
                             tap_dtype=torch.bfloat16)
    exact = K.lepe_windows(windows, lk.bfloat16().float(), lb.bfloat16().float(),
                           sp_h=sp_h, sp_w=sp_w)
    assert torch.equal(rounded, exact)


# (n, L, C, heads): stage-3 windows with 4 heads, stage-2 with 2, one head
ATTENTION = [(4, 98, 128, 4), (8, 56, 64, 2), (6, 56, 32, 1)]


@pytest.mark.parametrize("n,L,C,heads,fn", [
    (*geo, fn) for geo in ATTENTION for fn in ("_attn_windows", "_attn_windows_hb")
    if fn == "_attn_windows" or geo[3] >= 2])  # head blocks need two heads
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_attention_matches_jax(dtype, n, L, C, heads, fn):
    """``exp_attn3.py::k_off`` / ``k_full``: per-head and head-block
    attention on stacked windows are one function."""
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, dtype, n, L, C) for _ in range(3))
    scale = (C // heads) ** -0.5
    want = getattr(cb, fn)(qj, kj, vj, heads, scale, merge=1)
    got = K.window_attention(qt, kt, vt, heads=heads, scale=scale)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    _agree(got, want, dtype)


@pytest.mark.parametrize("direction", ["rows", "columns"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_attention_from_image_layout_matches_jax(dtype, direction):
    """``exp_attn.py``: one head on the rows (h-*) or columns (v-*) of the
    image, the columns by transposing as ``k_v_batched`` does."""
    rng = np.random.default_rng(5)
    B, H, W, d = 2, 8, 12, 16
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, dtype, B, H, W, d) for _ in range(3))
    scale = d ** -0.5
    if direction == "rows":
        win = lambda t: t.reshape(B * H, W, d)
        want = cb._attn_windows(win(qj), win(kj), win(vj), 1, scale, merge=1)
        want = want.reshape(B, H, W, d)
        got = K.window_attention(qt, kt, vt, heads=1, scale=scale, h_sp=1, w_sp=W)
    else:
        win = lambda t: t.transpose(0, 2, 1, 3).reshape(B * W, H, d)
        want = cb._attn_windows(win(qj), win(kj), win(vj), 1, scale, merge=1)
        want = want.reshape(B, W, H, d).transpose(0, 2, 1, 3)
        got = K.window_attention(qt, kt, vt, heads=1, scale=scale, h_sp=H, w_sp=1)
    _agree(got, want, dtype)


@pytest.mark.parametrize("mode", ["no_softmax", "copy", "softmax", "stage"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_attention_stub_modes_match_jax(dtype, mode):
    """``exp_attn3.py::k_dots`` (``p = s·1e-4``) and ``k_copy``; the parts
    that ``k_softmax`` and ``k_tile`` price, in this kernel's form: the
    first product and the softmax with the probabilities folded to the
    head's width, and ``k + v`` through the staging."""
    rng = np.random.default_rng(6)
    n, L, C, heads = 4, 98, 64, 2
    d = C // heads
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, dtype, n, L, C) for _ in range(3))
    scale = d ** -0.5
    if mode == "copy":
        want = (qj + kj + vj).astype(qj.dtype)
    elif mode == "stage":
        want = (kj.astype(jnp.float32) + vj.astype(jnp.float32)).astype(qj.dtype)
    else:
        outs = []
        for h in range(heads):
            sl = slice(h * d, (h + 1) * d)
            s = jax.lax.dot_general(qj[:, :, sl] * scale, kj[:, :, sl],
                                    (((2,), (2,)), ((0,), (0,))),
                                    preferred_element_type=jnp.float32)
            if mode == "softmax":
                p = jax.nn.softmax(s, axis=-1).astype(qj.dtype).astype(jnp.float32)
                p = jnp.pad(p, ((0, 0), (0, 0), (0, -L % d)))
                outs.append(p.reshape(n, L, -1, d).sum(2))
                continue
            p = (s * 1e-4).astype(qj.dtype)
            outs.append(jax.lax.dot_general(p, vj[:, :, sl], (((2,), (1,)), ((0,), (0,))),
                                            preferred_element_type=jnp.float32))
        want = jnp.concatenate(outs, -1).astype(qj.dtype)
    got = K.window_attention(qt, kt, vt, heads=heads, scale=scale, mode=mode)
    _agree(got, want, dtype)


def _mlp_params(rng, C):
    p = dict(s=rng.standard_normal(C) * 0.3 + 1, b=rng.standard_normal(C) * 0.1,
             w1=rng.standard_normal((C, 4 * C)) * C ** -0.5,
             b1=rng.standard_normal(4 * C) * 0.1,
             w2=rng.standard_normal((4 * C, C)) * (4 * C) ** -0.5,
             b2=rng.standard_normal(C) * 0.1)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    port = (torch.from_numpy(p["s"]), torch.from_numpy(p["b"]),
            torch.from_numpy(p["w1"].T.copy()), torch.from_numpy(p["b1"]),
            torch.from_numpy(p["w2"].T.copy()), torch.from_numpy(p["b2"]))
    return {k: jnp.asarray(v) for k, v in p.items()}, port


def _gelu(yf):
    return yf * 0.5 * (1.0 + cb._erf(yf * (2.0 ** -0.5)))


def _jax_mlp(x, p, body):
    """The MLP bodies of the experiment kernels on (rows, C)."""
    y = cb._layernorm(x, p["s"], p["b"])
    if body == "k64":  # exp_pack.py: GELU on the float32 fc1 accumulator
        yf = jnp.dot(y, p["w1"].astype(y.dtype),
                     preferred_element_type=jnp.float32) + p["b1"]
    else:              # exp_lane.py::k_mlp_u: fc1 rounded by _dot first
        yf = cb._dot(y, p["w1"], p["b1"]).astype(jnp.float32)
    y = _gelu(yf).astype(x.dtype)
    return x + cb._dot(y, p["w2"], p["b2"])


def _blockdiag(a):
    z = np.zeros_like(a)
    return np.block([[a, z], [z, a]])


@pytest.mark.parametrize("body", ["k64", "k_mlp_u", "paired"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ln_mlp_matches_jax_bodies(dtype, body):
    """``exp_pack.py::k64``, ``exp_lane.py::k_mlp_u``, and their lane-paired
    form (two pixels side by side, block-diagonal weights, LN statistics by
    an averaging matrix: ``k128`` / ``k_mlp_p``), which computes the unpaired
    function of the same bytes."""
    rng = np.random.default_rng(7)
    rows, C = 96, 64
    xj, xt = _pair(rng, dtype, rows, C)
    pj, port = _mlp_params(rng, C)
    if body == "paired":
        A = np.zeros((2 * C, 2 * C), np.float32)
        A[:C, :C] = A[C:, C:] = 1.0 / C
        two = lambda v: jnp.concatenate([v, v])
        xp = xj.reshape(rows // 2, 2 * C)
        xf = xp.astype(jnp.float32)
        mu = jnp.dot(xf, jnp.asarray(A), precision="highest")
        dlt = xf - mu
        var = jnp.dot(dlt * dlt, jnp.asarray(A), precision="highest")
        y = (dlt * jax.lax.rsqrt(var + 1e-5) * two(pj["s"]) + two(pj["b"])).astype(xp.dtype)
        y = cb._dot(y, jnp.asarray(_blockdiag(np.asarray(pj["w1"]))), two(pj["b1"]))
        y = _gelu(y.astype(jnp.float32)).astype(xp.dtype)
        y = cb._dot(y, jnp.asarray(_blockdiag(np.asarray(pj["w2"]))), two(pj["b2"]))
        want = (xp + y).reshape(rows, C)
    else:
        want = _jax_mlp(xj, pj, body)
    got = K.ln_mlp(xt, *port)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    _agree(got, want, dtype)


@pytest.mark.parametrize("act", ["gelu", "clamp"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ln_mlp_fold_matches_jax(dtype, act):
    """``exp_vpu.py::k_gelu`` / ``k_gelu_tanhless``: fc1 without LN or bias,
    the activation, the hidden's four C-groups summed."""
    rng = np.random.default_rng(8)
    rows, C = 80, 64
    xj, xt = _pair(rng, dtype, rows, C)
    pj, port = _mlp_params(rng, C)
    yf = cb._dot(xj, pj["w1"]).astype(jnp.float32)
    y = _gelu(yf) if act == "gelu" else yf * jnp.minimum(jnp.maximum(yf + 0.5, 0.0), 1.0)
    want = (y[:, :C] + y[:, C:2 * C] + y[:, 2 * C:3 * C] + y[:, 3 * C:]).astype(xj.dtype)
    got = K.ln_mlp(xt, None, None, port[2], None, act=act, ln=False, fold=True)
    _agree(got, want, dtype)


def test_ln_mlp_without_ln_is_the_mlp_of_x():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((10, 64)).astype(np.float32))
    _, port = _mlp_params(rng, 64)
    got = K.ln_mlp(x, None, None, *port[2:], ln=False)
    h = torch.nn.functional.gelu(x @ port[2].t() + port[3])
    assert torch.allclose(got, x + h @ port[4].t() + port[5], atol=1e-5)


def test_wrappers_refuse_bad_arguments():
    x = torch.zeros(4, 14, 8)
    taps = torch.zeros(3, 3, 8)
    with pytest.raises(ValueError):
        K.lepe_windows(x, taps, None, sp_h=2, sp_w=7, taps2=taps)         # no n0
    with pytest.raises(ValueError):
        K.lepe_windows(x, taps, None, sp_h=2, sp_w=8)                     # L != 16
    with pytest.raises(ValueError):
        K.lepe_windows(x, torch.zeros(3, 3, 4), None, sp_h=2, sp_w=7)     # taps' width
    with pytest.raises(ValueError):
        K.window_attention(x, x, x, heads=1, scale=1.0, mode="full")
    with pytest.raises(ValueError):
        K.window_attention(x, x, x, heads=1, scale=1.0, h_sp=2, w_sp=7)   # not an image
    with pytest.raises(ValueError):
        K.ln_mlp(torch.zeros(4, 64), None, None, torch.zeros(256, 64), None)  # ln needs LN
    with pytest.raises(ValueError):
        K.ln_mlp(torch.zeros(4, 64), None, None, torch.zeros(256, 64), None, ln=False,
                 act="relu")
    assert {"lepe_windows", "window_attention", "ln_mlp", "block_one"} <= set(K.launch_counts())


@pytest.mark.parametrize("sub", sorted(block_lab.SUBCOMMANDS))
def test_block_lab_subcommand_runs_on_cpu(sub, capsys):
    """Every subcommand through the entry point with the plain versions: one
    printed line a case, no launches counted, errors within tolerance."""
    rows = []
    K.reset_launch_counts()
    assert block_lab.main([sub, "--device", "cpu", "--batch", "2"], rows) == 0
    assert not any(K.launch_counts().values())
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(f"[lab:{sub}]")]
    assert rows and len(lines) == len(rows) + 1            # the header line
    for row, line in zip(rows, lines[1:]):
        assert row["case"] in line and "bound_ms=" in line and "ms=not measured" in line
        assert row["rel_l2"] <= block_lab.TOL and row["bound_by"] in ("bytes", "operations")
        assert row["per_run"] and set(row["per_run"]) <= set(K.launch_counts())
    if sub == "bisect":
        assert all(" OK " in line for line in lines[1:])
        assert sum("vs stripe_attention max_abs" in line for line in lines) == 4


def test_block_lab_refuses_a_missing_card_and_other_stages():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            block_lab.main(["lepe", "--batch", "1"])
    with pytest.raises(SystemExit):
        block_lab.main(["mlp", "--device", "cpu", "--stage", "2"])
    with pytest.raises(SystemExit):
        block_lab.main(["lepe", "--device", "cpu", "--stage", "31"])     # data, not run
    with pytest.raises(SystemExit):
        block_lab.main(["cum", "--device", "cpu", "--stage", "4"])       # one branch
    assert block_lab.STAGES[33] == dict(H=24, W=24, C=384, heads=16, split=12, last=False)
    assert block_lab.branch_geometry(3) == (7, 14, 128, 4, 2)
    assert block_lab.branch_geometry(4) == (7, 7, 512, 16, 1)


def test_ulp_bf16_is_the_spacing_of_bf16_values():
    """8 significant bits: the step at [1, 2) is 2^-7, at [2, 4) 2^-6, at
    [0.5, 1) 2^-8; a value that adds half a step rounds, one step does not."""
    assert [block_lab.ulp_bf16(v) for v in (1.0, 1.99, 3.0, 0.75)] == \
        [2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 2.0 ** -8]
    one = torch.tensor([1.0], dtype=torch.bfloat16)
    assert float(one + torch.tensor([2.0 ** -7], dtype=torch.bfloat16)) == 1.0 + 2.0 ** -7
    assert float(one + torch.tensor([2.0 ** -9], dtype=torch.bfloat16)) == 1.0


def _bf16(*v):
    return torch.tensor(v, dtype=torch.bfloat16)


@pytest.mark.parametrize("ulps,ok", [(0, True), (1, True), (2, True), (3, False)])
def test_parts_vs_whole_rule_at_the_output_scale(ulps, ok):
    """At scale 3 (the whole's largest magnitude; LePE 0) a bf16 step is
    2^-6: the parts may sit 2 steps off the whole and not 3."""
    whole, lepe = _bf16(3.0, -0.5), _bf16(0.0, 0.0)
    att = _bf16(3.0 + ulps * 2.0 ** -6, -0.5)
    assert float(att[0]) == 3.0 + ulps * 2.0 ** -6  # exact in bf16
    if ok:
        assert "2 ulps 3.125e-02" in block_lab.check_parts_vs_whole(att, lepe, whole)
    else:
        with pytest.raises(block_lab.LabFailure, match="> 2 ulps"):
            block_lab.check_parts_vs_whole(att, lepe, whole)


@pytest.mark.parametrize("ulps,ok", [(2, True), (3, False)])
def test_parts_vs_whole_rule_at_the_lepe_scale(ulps, ok):
    """The LePE term's magnitude sets the scale when it is the larger: whole
    1.0, LePE -4 (a step of 2^-5 at the sum's terms), so the parts' bf16 sum
    may land 2 such steps off (0.0625, 8 steps of the whole's own 2^-7) and
    not 3."""
    whole, lepe = _bf16(1.0), _bf16(-4.0)
    att = _bf16(5.0 + ulps * 2.0 ** -5)
    assert float((att + lepe)[0]) == 1.0 + ulps * 2.0 ** -5
    if ok:
        assert "2 ulps 6.250e-02" in block_lab.check_parts_vs_whole(att, lepe, whole)
    else:
        with pytest.raises(block_lab.LabFailure, match="at scale 4.000"):
            block_lab.check_parts_vs_whole(att, lepe, whole)
