"""The O(L) lower-envelope pass of ``edt.cu``, in what the CPU can check.

``kernels.edt_envelope_reference`` mirrors the kernel line by line (the
same hull build and walk, the same predicates in the same arithmetic, the
same tie rule and output expression). It is held bit for bit to
``edt_pass_plain`` and to the JAX ``edt_pass`` (Pallas, interpret mode) on
the lines where exactness is at stake; the two predicates are held to
exact rational arithmetic (``fractions.Fraction``) on their float64 path
and on their error-free path, near ties included. ``edt_pass_plan``
mirrors the kernel's lines a CTA and shared memory.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.ops import edt as jax_edt
from cswin_unet_tpu_torch.ops.cuda import kernels as K

torch.set_num_threads(2)

INF = np.float32(1e12)  # "no seed", as edt_sq writes it


def _lines(case: str, L: int, rng) -> np.ndarray:
    n = 6
    if case == "all_inf":
        return np.full((n, L), INF, np.float32)
    if case == "one_seed":
        f = np.full((n, L), INF, np.float32)
        f[np.arange(n), rng.integers(0, L, n)] = 0.0
        return f
    if case == "equidistant":  # seeds 2s apart: exact ties midway
        f = np.full((n, L), INF, np.float32)
        for r in range(n):
            f[r, r % 3::2 * (r + 1)] = 0.0
        return f
    if case == "edt_chain":  # the integer partial sums the second pass sees
        seeds = rng.random((n, L, L)) < 0.02
        f0 = np.where(seeds, 0.0, INF).astype(np.float32)
        f1 = K.edt_pass_plain(torch.from_numpy(f0), 2).numpy()
        return np.ascontiguousarray(np.swapaxes(f1, 1, 2).reshape(-1, L)[:n * 4])
    if case == "uniform":  # the GPU test's seeds, partial sums and +inf
        f = np.where(rng.random((n, L)) < 0.1, 0.0, INF).astype(np.float32)
        part = rng.random((n, L)) < 0.1
        f[part] = rng.uniform(0, 300, part.sum()).astype(np.float32)
        return f
    if case == "inf_and_small":  # 1e12 beside small finite values
        f = np.full((n, L), INF, np.float32)
        part = rng.random((n, L)) < 0.05
        f[part] = rng.uniform(0, 5, part.sum()).astype(np.float32)
        f[:, -1] = np.float32(1e-3)
        return f
    if case == "near_1e12":  # large integers the function accepts
        k = rng.integers(0, 200, (n, L)).astype(np.float32)
        return (INF - np.float32(65536) * k).astype(np.float32)
    raise ValueError(case)


CASES = ["all_inf", "one_seed", "equidistant", "edt_chain", "uniform", "inf_and_small",
         "near_1e12"]


@pytest.mark.parametrize("L", [1, 2, 48, 512])
@pytest.mark.parametrize("case", CASES)
def test_envelope_equals_plain_and_pallas(case, L):
    if case == "edt_chain" and L > 48:
        L = 64  # the (n, L, L) seed volume stays small
    f = _lines(case, L, np.random.default_rng(L))
    t = torch.from_numpy(f)
    got = K.edt_envelope_reference(t)
    assert got.dtype == torch.float32 and got.shape == t.shape
    assert torch.equal(got, K.edt_pass_plain(t))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_edt.edt_pass(jnp.asarray(f), interpret=True)))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_envelope_along_every_axis(axis):
    rng = np.random.default_rng(7)
    f = np.where(rng.random((5, 17, 33)) < 0.1, 0.0, INF).astype(np.float32)
    part = rng.random(f.shape) < 0.1
    f[part] = rng.uniform(0, 300, part.sum()).astype(np.float32)
    t = torch.from_numpy(f)
    assert torch.equal(K.edt_envelope_reference(t, axis), K.edt_pass_plain(t, axis))


def test_envelope_non_finite_and_negative_values():
    """+inf is never a minimiser (a line of +inf stays +inf), NaN and -inf
    take the line as the plain min does; negative, subnormal and
    non-integer values take the error-free predicates."""
    f = np.array([[1e12, np.nan, 0, 1],
                  [np.inf, np.inf, np.inf, np.inf],
                  [-np.inf, 0, 1, 2],
                  [np.inf, 3, np.inf, -5],
                  [1e-45, -2.5, 7e20, 3.25],
                  [1e12, 1e-30, -1e-30, 1e12]], np.float32)
    got = K.edt_envelope_reference(torch.from_numpy(f))
    torch.testing.assert_close(got, K.edt_pass_plain(torch.from_numpy(f)), rtol=0, atol=0,
                               equal_nan=True)
    assert torch.isnan(got[0]).all() and (got[1] == np.inf).all()
    assert (got[2] == -np.inf).all()


@pytest.mark.parametrize("value", [0.0, -0.0, 5.25, 1e12, np.inf, -np.inf])
def test_one_value_lines_come_back_as_they_are(value):
    """A line of one value is its own output (0 + f[i], so -0 comes back
    +0 as the plain sum gives it); a NaN among them still takes the line."""
    f = np.full((3, 48), value, np.float32)
    f[2, 7] = np.nan
    got, want = (fn(torch.from_numpy(f)) for fn in (K.edt_envelope_reference, K.edt_pass_plain))
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got[:2].view(torch.int32), want[:2].view(torch.int32))
    assert torch.isnan(got[2]).all()


def _exact_keep(a, fa, b, fb, q, fq) -> bool:
    d1, d2 = b - a, q - b
    return (d1 * Fraction(float(fq)) + d2 * Fraction(float(fa)) - (d1 + d2) * Fraction(float(fb))
            + d1 * d2 * (d1 + d2)) > 0


def _exact_advance(v, fv, w, fw, i) -> bool:
    return Fraction(float(fw)) - Fraction(float(fv)) + (w - v) * (v + w - 2 * i) <= 0


def _near_ties(rng, n, integers):
    """(a, fa, b, fb, q, fq) with fb the float32 values around the one that
    puts (b, F(b)) on the segment a-q."""
    out = []
    for _ in range(n):
        a, b, q = sorted(rng.choice(2048, 3, replace=False).tolist())
        if integers:
            fa, fq = (np.float32(rng.integers(0, 2**24) * rng.choice([1, 65536]))
                      for _ in range(2))
        else:
            fa, fq = (np.float32(rng.uniform(0, 300) * 10.0 ** rng.integers(-30, 12))
                      for _ in range(2))
        d1, d2 = b - a, q - b
        tie = Fraction(d1 * Fraction(float(fq)) + d2 * Fraction(float(fa)) + d1 * d2 * (d1 + d2),
                       d1 + d2)
        near = np.float32(float(tie))
        fbs = [np.nextafter(near, -np.inf), near, np.nextafter(near, np.inf)]
        if integers:  # the integers either side (float32 holds them exactly)
            fbs += [np.float32(tie.numerator // tie.denominator + k) for k in (0, 1)]
        out += [(a, fa, b, np.float32(fb), q, fq) for fb in fbs]
    return out


@pytest.mark.parametrize("integers", [True, False])
def test_keep_is_exact_at_near_ties(integers):
    for a, fa, b, fb, q, fq in _near_ties(np.random.default_rng(int(integers)), 300, integers):
        want = _exact_keep(a, fa, b, fb, q, fq)
        pa, pb, pq = (K._pt(j, float(v), 2048) for j, v in ((a, fa), (b, fb), (q, fq)))
        assert K.edt_keep(pa, pb, pq) == want
        slow = [p._replace(n=None) for p in (pa, pb, pq)]  # the error-free path
        assert K.edt_keep(*slow) == want


@pytest.mark.parametrize("integers", [True, False])
def test_advance_is_exact_at_near_ties(integers):
    rng = np.random.default_rng(10 + int(integers))
    for _ in range(600):
        v, w = sorted(rng.choice(2048, 2, replace=False).tolist())
        i = int(rng.integers(0, 2048))
        fv = (np.float32(rng.integers(0, 2**24) * 65536) if integers
              else np.float32(rng.uniform(0, 300) * 10.0 ** rng.integers(-30, 12)))
        tie = np.float32(float(fv) - (w - v) * (v + w - 2 * i))
        for fw in (np.nextafter(tie, -np.inf), tie, np.nextafter(tie, np.inf), tie - 1,
                   tie + 1):
            want = _exact_advance(v, fv, w, fw, i)
            pv, pw = K._pt(v, float(fv), 2048), K._pt(w, float(fw), 2048)
            assert K.edt_advance(pv, pw, i) == want
            assert K.edt_advance(pv._replace(n=None), pw._replace(n=None), i) == want


@pytest.mark.parametrize("L", [1, 2, 48, 64, 65, 170, 512, 1000, 1760, 2048])
@pytest.mark.parametrize("last", [True, False])
def test_edt_pass_plan_fits_shared_memory(L, last):
    p = K.edt_pass_plan(L, last)
    assert p.parts in (1, 2, 4, 8) and p.parts * p.segment >= L > p.parts * (p.segment - 1)
    assert p.segment <= 32 or p.parts == 8  # short parts where 8 warps allow
    assert 1 <= p.lines <= 256 // p.parts and p.smem_bytes <= 232448
    if L <= 512:  # the volume's axes: 32 lines a group of warps
        assert p.lines == 256 // p.parts
    if L == 512:  # two CTAs an SM (228 KB, 1 KB reserved a CTA)
        assert 2 * (p.smem_bytes + 1024) <= 228 * 1024
    assert K.edt_pass_plan(65536, last).lines == 0


def _whole_line_hull(vals: list[float]) -> list[int]:
    """Felzenszwalb-Huttenlocher's stack over the whole line, in exact
    rational arithmetic."""
    stack: list[int] = []
    for q, fq in enumerate(vals):
        if not np.isfinite(fq):
            continue
        while len(stack) >= 2 and not _exact_keep(stack[-2], vals[stack[-2]], stack[-1],
                                                   vals[stack[-1]], q, fq):
            stack.pop()
        stack.append(q)
    return stack


@pytest.mark.parametrize("kind", ["seeds", "small_ints", "concave", "uniform", "with_inf"])
def test_part_merge_gives_the_whole_line_hull(kind):
    """The kernel builds each part's hull and merges them (pops across
    parts, the convex rest of a part kept once two of its points stand):
    without pruning, the result is the hull of the whole line."""
    rng = np.random.default_rng(5)
    for L in (33, 48, 65, 66, 100, 131, 200, 257, 300, 600):
        for _ in range(4):
            if kind in ("seeds", "with_inf"):
                f = np.where(rng.random(L) < 0.1, 0.0, INF)
                if kind == "with_inf":
                    f[rng.random(L) < 0.5] = np.inf
            elif kind == "small_ints":
                f = rng.integers(0, 60, L)
            elif kind == "concave":  # F(j) falls: the earlier parts' hulls are popped away
                f = -2.0 * np.arange(L) ** 2 + rng.integers(0, 3, L)
            else:
                f = rng.uniform(0, 300, L)
            vals = [float(v) for v in f.astype(np.float32)]
            plan = K.edt_pass_plan(L, True)
            hulls = []
            for part in range(plan.parts):
                stack: list = []
                for q in range(part * plan.segment, min(L, (part + 1) * plan.segment)):
                    if not np.isfinite(vals[q]):
                        continue
                    p = K._pt(q, vals[q], L)
                    while len(stack) >= 2 and not K.edt_keep(stack[-2], stack[-1], p):
                        stack.pop()
                    stack.append(p)
                hulls.append(stack)
            lo, hi = K._edt_merge(hulls)
            merged = [hulls[w][e].j for w in range(plan.parts) for e in range(lo[w], hi[w])]
            assert merged == _whole_line_hull(vals)


def test_pruning_keeps_every_minimiser():
    """A point above the line's least value plus (L - 1)^2 never wins: the
    pruned parts' merged hull still gives the plain result, and on a line
    with a seed it holds no 1e12 point."""
    rng = np.random.default_rng(9)
    for L in (48, 512):
        f = np.full(L, INF, np.float32)
        f[rng.integers(0, L, 3)] = 0.0
        f[rng.integers(0, L, 3)] = np.float32((L - 1) ** 2)  # at the bound: kept
        hulls, _ = K._edt_parts([float(v) for v in f], L)
        assert all(p.f < 1e12 for h in hulls for p in h)
        assert any(p.f == (L - 1) ** 2 for h in hulls for p in h)
        t = torch.from_numpy(f[None])
        assert torch.equal(K.edt_envelope_reference(t), K.edt_pass_plain(t))
