"""Matmul precision is chosen per site and set explicitly (ops/sampling.py
header). The CPU ignores precision, so these tests read the choice out
of the traced program: every ``dot_general`` a site emits must carry the
precision the site's bar needs — never the backend default, which is
TF32 for f32 dots on the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from retrocapture_tpu.ops import sampling as S

HIGHEST = (jax.lax.Precision.HIGHEST,) * 2
DEFAULT = (jax.lax.Precision.DEFAULT,) * 2


def _dot_precisions(fn, *args):
    """Precision params of every dot_general in fn's jaxpr (recursing
    into nested jaxprs)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for p in eqn.params.values():
                for sub in p if isinstance(p, (list, tuple)) else (p,):
                    inner = getattr(sub, "jaxpr", None)
                    if inner is not None:
                        walk(getattr(inner, "jaxpr", inner))

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


# 24 -> 108 rows (ratio 4.5) and 32 -> 70 columns never lower to
# slices, so these sites reach their matmuls.
TEX = np.random.default_rng(0).random((24, 32, 4)).astype(np.float32)
U = ((np.arange(70) + 0.5) / 70).astype(np.float32)
V = ((np.arange(108) + 0.5) / 108).astype(np.float32)
UU, VV = np.meshgrid(U, V)


def _affine_linear(t):
    return S.sample2d_affine(
        t, (1.0 / 70, 0.0, 0.5 / 70), (0.0, 1.0 / 108, 0.5 / 108), 108, 70,
        filter_linear=True,
    )


def _separable_traced(t):
    return S.sample2d_separable(t, jnp.asarray(U), jnp.asarray(V), filter_linear=True)


def _concrete(linear, quant, dedup=False):
    def f(t):
        if dedup:
            with S.tap_dedup_scope():
                return S.sample2d(t, UU, VV, filter_linear=linear, quantized_u8=quant)
        return S.sample2d(t, UU, VV, filter_linear=linear, quantized_u8=quant)

    return f


SITES = [
    pytest.param(_affine_linear, HIGHEST, id="affine-linear"),
    pytest.param(_separable_traced, HIGHEST, id="separable-traced"),
    pytest.param(_concrete(True, False), HIGHEST, id="concrete-linear"),
    pytest.param(_concrete(False, True), DEFAULT, id="concrete-nearest-requant"),
    pytest.param(_concrete(False, False), HIGHEST, id="concrete-nearest-offgrid"),
    pytest.param(_concrete(False, True, dedup=True), DEFAULT, id="dedup-requant"),
    pytest.param(_concrete(False, False, dedup=True), HIGHEST, id="dedup-offgrid"),
]


@pytest.mark.parametrize("fn,want", SITES)
def test_sampling_site_precision(fn, want):
    precs = _dot_precisions(fn, jnp.asarray(TEX))
    assert precs, "site emitted no matmul"
    assert all(p == want for p in precs), precs


def test_viewport_blit_has_no_matmul():
    assert _dot_precisions(lambda t: S.resize_linear(t, 1920, 1080), TEX[..., :3]) == []


@pytest.mark.parametrize("op", ["mat*vec", "vec*mat", "mat*mat", "outer"])
def test_glsl_matrix_products_are_f32(op):
    from retrocapture_tpu.frontend import builtins as B
    from retrocapture_tpu.frontend.values import GType, V

    def f(x):
        vec = V(x[..., :3], GType("float", (3,)))
        mat = V(jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), x.shape[:2] + (3, 3)),
                GType("float", (3, 3)))
        if op == "mat*vec":
            return B._mat_mul(mat, vec).data
        if op == "vec*mat":
            return B._mat_mul(vec, mat).data
        if op == "mat*mat":
            return B._mat_mul(mat, mat).data
        return B._b_outer_product(vec, vec).data

    precs = _dot_precisions(f, jnp.asarray(TEX))
    assert precs and all(p == HIGHEST for p in precs), precs
