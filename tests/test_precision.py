"""Every matrix product on the phasing path states Precision.HIGHEST.

On a GPU a float32 dot_general with no stated precision may run in TF32
(about three decimal digits), far outside the 1e-6 bounds the transforms and
the Newton–Schulz polar iteration are pinned to. These tests trace each
stage and require HIGHEST on every dot_general in its program, including
products nested in scans.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import lax

from xframe_tpu.library.jaxpr_precision import dot_precisions, with_precision

HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


@pytest.fixture(scope="module")
def demo():
    from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu.projects.fxs.demo import make_demo_problem
    return make_demo_problem(10, 6, procrustes_method="newton_schulz",
                             ns_schedule=DEFAULT_SCHEDULE)


def _stages(p):
    ft, mtip = p.ft, p.mtip
    rho = p.initial_density_batch(0, 1)[0]
    c = ft.sht.forward(rho)
    inten = jnp.abs(ft.forward(rho)) ** 2
    Ilm = ft.sht.forward_real(inten)
    sup = jnp.asarray(mtip.initial_support)
    beta = jnp.float32(0.5)
    M = jnp.asarray(np.eye(7) + 0.1 * np.ones((7, 7)), jnp.complex64)[None]
    from xframe_tpu.projects.fxs.projections import polar_unitary_newton_schulz
    from xframe_tpu.ops.so3 import SO3Correlator, rotate_coeff
    corr = SO3Correlator(ft.sht.l_max)
    D = jnp.asarray(np.tile(np.eye(c.shape[-2]), (c.shape[-1], 1, 1)),
                    jnp.complex64)

    def step(method):
        return lambda r: mtip.mtip_iteration(r, sup, beta, method, True)[0]

    return {
        "sht_forward": (ft.sht.forward, rho),
        "sht_inverse": (ft.sht.inverse, c),
        "sht_forward_real": (ft.sht.forward_real, inten),
        "sht_inverse_real": (ft.sht.inverse_real, Ilm),
        "hankel_forward": (ft.hankel.forward, c),
        "hankel_inverse": (ft.hankel.inverse, c),
        "ns_polar_minimax": (lambda m: polar_unitary_newton_schulz(
            m, schedule=mtip.rc.ns_schedule), M),
        "ns_polar_fixed": (polar_unitary_newton_schulz, M),
        "data_projection": (mtip.rc, Ilm),
        "mtip_iteration_HIO": (step("HIO"), rho),
        "mtip_iteration_ER": (step("ER"), rho),
        "mtip_iteration_RAAR": (step("RAAR"), rho),
        "so3_correlate": (lambda a: corr.correlate(a, a), c[0]),
        "so3_rotate": (lambda a: rotate_coeff(a, D), c),
    }


STAGES = ["sht_forward", "sht_inverse", "sht_forward_real",
          "sht_inverse_real", "hankel_forward", "hankel_inverse",
          "ns_polar_minimax", "ns_polar_fixed", "data_projection",
          "mtip_iteration_HIO", "mtip_iteration_ER", "mtip_iteration_RAAR",
          "so3_correlate", "so3_rotate"]


@pytest.mark.parametrize("stage", STAGES)
def test_every_product_states_highest(demo, stage):
    fn, arg = _stages(demo)[stage]
    precisions = dot_precisions(fn, arg)
    assert precisions, f"{stage}: no dot_general traced"
    assert all(p == HIGHEST for p in precisions), (stage, precisions)


def test_with_precision_rewrites_every_product(demo):
    """with_precision(fn, DEFAULT) reaches products nested in scans (the
    Newton–Schulz steps) and computes the same function; on the CPU the
    backend default is full float32, so results agree exactly."""
    fn, arg = _stages(demo)["mtip_iteration_HIO"]
    relaxed = with_precision(fn, lax.Precision.DEFAULT)
    precisions = dot_precisions(relaxed, arg)
    assert precisions
    assert all(p == (lax.Precision.DEFAULT, lax.Precision.DEFAULT)
               for p in precisions)
    np.testing.assert_array_equal(np.asarray(jax.jit(relaxed)(arg)),
                                  np.asarray(jax.jit(fn)(arg)))
