#!/usr/bin/env python
"""SHT and composed-FT accuracy against a float64 host reference.

HostSHT64 is a numpy float64 implementation with the exact layout and
normalization of ops.sht. `measure` gives the forward / inverse / round-trip
relative L2 error of the float32 jnp SHT at one (L, n_theta, n_phi);
`composed_ft_accuracy` the error of the full FT = iSHT∘Hankel∘SHT against
a float64 host composition. Both run on JAX's default device:

    python scripts/sht_accuracy.py                 # the four standard cases
    python scripts/sht_accuracy.py 64,256,512      # L,n_theta,n_phi
"""
import sys

import numpy as np
import jax

from xframe_tpu.library.legendre import gauss_legendre, sph_legendre_table_full_m
from xframe_tpu.ops.sht import SphericalHarmonicTransform


class HostSHT64:
    """Float64 numpy reference with the exact layout/normalization of ops.sht."""

    def __init__(self, l_max, n_theta, n_phi):
        self.L, self.nt, self.nph = l_max, n_theta, n_phi
        x, w = gauss_legendre(n_theta)
        x, w = x[::-1].copy(), w[::-1].copy()
        P = sph_legendre_table_full_m(l_max, x).astype(np.float64)
        self.P = P
        self.PW = P * w[None, :, None]
        ls = np.arange(l_max + 1)[None, :]
        ms = np.arange(-l_max, l_max + 1)[:, None]
        self.mask = ls >= np.abs(ms)

    def forward(self, f):
        L = self.L
        fm = np.fft.fft(f, axis=-1)
        fm = np.concatenate([fm[..., -L:], fm[..., : L + 1]], axis=-1) \
            * (2 * np.pi / self.nph)
        return np.einsum("...tm,mtl->...ml", fm, self.PW)

    def inverse(self, c):
        L = self.L
        fm = np.einsum("...ml,mtl->...tm", c, self.P)
        pad = self.nph - (2 * L + 1)
        zeros = np.zeros(fm.shape[:-1] + (pad,), dtype=fm.dtype)
        full = np.concatenate([fm[..., L:], zeros, fm[..., :L]], axis=-1)
        return np.fft.ifft(full, axis=-1) * self.nph


def rel(a, b):
    return float(np.linalg.norm(np.ravel(a - b)) / np.linalg.norm(np.ravel(b)))


def measure(L, nt, nph, n_q=4, seed=0):
    """Relative errors of the float32 jnp SHT on white band-limited
    coefficients: forward (f64 field → coefficients), inverse, round trip."""
    ref = HostSHT64(L, nt, nph)
    rng = np.random.default_rng(seed)
    c0 = (rng.standard_normal((n_q, 2 * L + 1, L + 1))
          + 1j * rng.standard_normal((n_q, 2 * L + 1, L + 1))) * ref.mask
    f64 = ref.inverse(c0)                # band-limited field, float64
    sht = SphericalHarmonicTransform(L, n_theta=nt, n_phi=nph)
    f32 = np.asarray(f64, dtype=np.complex64)
    c_j = np.asarray(jax.jit(sht.forward)(f32))
    f_j = np.asarray(jax.jit(sht.inverse)(c0.astype(np.complex64)))
    rt_j = np.asarray(jax.jit(lambda x: sht.forward(sht.inverse(x)))(
        c0.astype(np.complex64)))
    return {
        "sanity_f64": rel(ref.forward(f64), c0),
        "forward": rel(c_j * ref.mask, c0),
        "inverse": rel(f_j, f64),
        "roundtrip": rel(rt_j * ref.mask, c0),
    }


def composed_ft_accuracy(ft, forward_and_roundtrip=None, shell_stride=8,
                         seed=3):
    """Composed FT of a float32 SphericalFourierTransform against a float64
    host composition, on white band-limited coefficients. Band-limit
    identities keep the host side affordable (SHT∘iSHT is exact on
    band-limited coefficients, so host analysis steps are skipped), and only
    every `shell_stride`-th radial shell is synthesized in f64 (the Hankel
    still mixes all shells). forward_and_roundtrip: the device function to
    test (default jit(ft.forward_and_roundtrip)).

    → {"forward": rel. L2 of FT(ρ), "roundtrip": of iFT(FT(ρ)),
       "defect_gap": |f32 − f64| round-trip quadrature defect}."""
    from xframe_tpu.ops.hankel import generate_weights, assemble_weights
    nq, L = ft.n_radial_points, ft.sht.l_max
    ref = HostSHT64(L, ft.sht.n_theta, ft.sht.n_phi)
    rng = np.random.default_rng(seed)
    c0 = (rng.standard_normal((nq, 2 * L + 1, L + 1))
          + 1j * rng.standard_normal((nq, 2 * L + 1, L + 1))) * ref.mask
    rho64 = ref.inverse(c0)
    wd = generate_weights(L, nq, ft.reciprocity_coefficient, 3, ft.mode)
    w64 = assemble_weights(np.asarray(wd['weights']), ft.r_max,
                           ft.reciprocity_coefficient, 3, ft.mode,
                           dtype=np.complex128)
    skip = 1 if ft.hankel.skip_zero else 0
    cf64 = np.einsum('kpl,kml->pml', w64['forward'], c0[skip:], optimize=True)
    cr64 = np.einsum('kpl,kml->pml', w64['inverse'], cf64[skip:],
                     optimize=True)
    sel = np.arange(0, nq, shell_stride)
    psi64 = ref.inverse(cf64[sel])
    rt64 = ref.inverse(cr64[sel])
    fn = forward_and_roundtrip or jax.jit(ft.forward_and_roundtrip)
    psi32, rt32 = fn(rho64.astype(np.complex64))
    psi32 = np.asarray(psi32)[sel].astype(np.complex128)
    rt32 = np.asarray(rt32)[sel].astype(np.complex128)
    return {"forward": rel(psi32, psi64), "roundtrip": rel(rt32, rt64),
            "defect_gap": abs(rel(rt32, rho64[sel]) - rel(rt64, rho64[sel]))}


if __name__ == "__main__":
    cases = [(16, 64, 128), (64, 256, 512), (127, 320, 640), (128, 320, 640)]
    if len(sys.argv) > 1:
        cases = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]]
    print("device:", jax.devices()[0].platform, jax.devices()[0].device_kind)
    for L, nt, nph in cases:
        r = measure(L, nt, nph)
        print(f"L={L:4d} grid {nt}x{nph} f32:",
              " ".join(f"{k}={v:.3e}" for k, v in r.items()), flush=True)
