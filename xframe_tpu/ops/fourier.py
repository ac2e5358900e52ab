"""Polar/spherical Fourier transforms on (r,θ,φ) grids.

FT = iSHT ∘ Hankel ∘ SHT (reference fourier_transforms.py:49-86), fully
jit-able: two batched Legendre matmuls + one batched per-l Hankel matmul +
two FFTs, all on device. The reference's GPU path crossed a process +
SharedMemory boundary per Hankel call (Multiprocessing.py:1033-1117); here the
whole chain fuses into one XLA computation.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import jax.numpy as jnp

from xframe_tpu.ops.sht import SphericalHarmonicTransform, CircularHarmonicTransform
from xframe_tpu.ops.hankel import (
    SphericalHankelTransform, PolarHankelTransform, generate_weights, radial_grids,
)


class SphericalFourierTransform:
    """3D FT between real (r,θ,φ) and reciprocal (q,θ,φ) spherical grids."""

    def __init__(self, n_radial_points: int, l_max: int, q_max: float = None,
                 mode: str = 'midpoint', reciprocity_coefficient: float = np.pi,
                 n_theta: int = None, n_phi: int = None, real_dtype=jnp.float32,
                 weights_dict: dict = None):
        if q_max is None:
            q_max = float(np.pi * n_radial_points / 250.0)
        self.mode = mode
        self.reciprocity_coefficient = reciprocity_coefficient
        self.rs, self.qs, self.r_max = radial_grids(mode, q_max, n_radial_points,
                                                    reciprocity_coefficient)
        self.q_max = q_max
        self.n_radial_points = n_radial_points
        self.sht = SphericalHarmonicTransform(l_max, n_theta=n_theta, n_phi=n_phi,
                                              real_dtype=real_dtype)
        if weights_dict is None:
            weights_dict = generate_weights(l_max, n_radial_points,
                                            reciprocity_coefficient, 3, mode)
        self.hankel = SphericalHankelTransform(weights_dict, self.r_max,
                                               reciprocity_coefficient, real_dtype)

    @property
    def grid_shape(self):
        return (self.n_radial_points, self.sht.n_theta, self.sht.n_phi)

    @property
    def grid_pair(self):
        """(real (r,θ,φ) grid, reciprocal (q,θ,φ) grid) — the reference's
        FTGridPair surface (pythonLibrary.py:1045)."""
        from xframe_tpu.library.shapes import spherical_grid
        return (spherical_grid(self.rs, self.sht.theta, self.sht.phi),
                spherical_grid(self.qs, self.sht.theta, self.sht.phi))

    # ---------------------------------------------- big tables as arguments
    def arg_tables(self):
        """The transform's big numeric tables as a flat dict of REAL host
        arrays, to be passed into jit as ARGUMENTS instead of closed-over
        constants: at production scale (N_q ≥ 256, L = 128) the Hankel
        weights alone are 135 MB, and every traced SHT call would embed its
        own copy of the Legendre tables (4.3 MB at the tutorial's L = 64,
        ~90 copies in the 600-iteration program) — as constants they bloat
        the program and key the compile cache on the data. Complex tables
        ship as re/im planes and recombine in-trace. Use with `bound_tables`:

            tables = ft.arg_tables()
            out = jax.jit(lambda t, x: ft.bound_run(t, ft.forward, x)
                          )(tables, x)
        """
        t = {}
        h = self.hankel
        t["h_wf_re"] = np.ascontiguousarray(h._wf.real)
        t["h_wf_im"] = np.ascontiguousarray(h._wf.imag)
        t["h_wi_re"] = np.ascontiguousarray(h._wi.real)
        t["h_wi_im"] = np.ascontiguousarray(h._wi.imag)
        for name in self._sht_table_names():
            t["sht" + name] = getattr(self.sht, name)
        return t

    def _sht_table_names(self):
        """The Legendre tables the SHT's contractions read."""
        return (("_P_e", "_P_o", "_PW_e", "_PW_o") if self.sht._use_sym
                else ("_P", "_PW"))

    @contextmanager
    def bound_tables(self, tables):
        """Temporarily swap the held host tables for the given (traced)
        values — call INSIDE the jitted function with the dict passed as an
        argument. Missing entries keep the embedded-constant behavior
        (degrades payload size, never correctness)."""
        saves = []

        def swap(obj, attr, val):
            saves.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, val)

        try:
            if tables:
                if "h_wf_re" in tables:
                    swap(self.hankel, "_wf",
                         tables["h_wf_re"] + 1j * tables["h_wf_im"])
                    swap(self.hankel, "_wi",
                         tables["h_wi_re"] + 1j * tables["h_wi_im"])
                for name in self._sht_table_names():
                    if "sht" + name in tables:
                        swap(self.sht, name, tables["sht" + name])
            yield
        finally:
            for obj, attr, val in reversed(saves):
                setattr(obj, attr, val)

    def bound_run(self, tables, fn, *args):
        with self.bound_tables(tables):
            return fn(*args)

    def forward(self, density):
        """ρ(r,θ,φ) → ψ(q,θ,φ)."""
        return self.sht.inverse(self.hankel.forward(self.sht.forward(density)))

    def inverse(self, amplitude):
        """ψ(q,θ,φ) → ρ(r,θ,φ)."""
        return self.sht.inverse(self.hankel.inverse(self.sht.forward(amplitude)))

    def forward_coeff(self, coeff):
        """f_lm(r) → F_lm(q) (padded (n_r, 2L+1, L+1) layout)."""
        return self.hankel.forward(coeff)

    def inverse_coeff(self, coeff):
        return self.hankel.inverse(coeff)

    def forward_and_roundtrip(self, density):
        """(FT(ρ), iFT(FT(ρ))) sharing one analysis: SHT∘iSHT is exact on
        band-limited coefficients, so the roundtrip defect needs only the
        Hankel pair + one extra synthesis (used by ft-stabilization)."""
        c = self.sht.forward(density)
        cf = self.hankel.forward(c)
        psi = self.sht.inverse(cf)
        rt = self.sht.inverse(self.hankel.inverse(cf))
        return psi, rt


class PolarFourierTransform:
    """2D FT between (r,φ) and (q,φ) polar grids."""

    def __init__(self, n_radial_points: int, m_max: int, n_phi: int, q_max: float,
                 mode: str = 'midpoint', reciprocity_coefficient: float = np.pi,
                 real_dtype=jnp.float32, weights_dict: dict = None):
        self.mode = mode
        self.reciprocity_coefficient = reciprocity_coefficient
        self.rs, self.qs, self.r_max = radial_grids(mode, q_max, n_radial_points,
                                                    reciprocity_coefficient)
        self.q_max = q_max
        self.m_max = m_max
        self.n_phi = n_phi
        self.n_radial_points = n_radial_points
        self.cht = CircularHarmonicTransform(n_phi, real_dtype=real_dtype)
        if weights_dict is None:
            weights_dict = generate_weights(m_max, n_radial_points,
                                            reciprocity_coefficient, 2, mode)
        self.hankel = PolarHankelTransform(weights_dict, self.r_max,
                                           reciprocity_coefficient, real_dtype)

    def _apply(self, hankel_fn, f):
        # FFT-order m selection [0..M, -M..-1] via slices (no gather/scatter)
        M = self.m_max
        c_full = self.cht.forward(f)
        parts = [c_full[..., : M + 1]] + ([c_full[..., -M:]] if M > 0 else [])
        c = jnp.concatenate(parts, axis=-1)
        g = hankel_fn(c)
        pad = self.n_phi - (2 * M + 1)
        zeros = jnp.zeros(g.shape[:-1] + (pad,), dtype=g.dtype)
        full = jnp.concatenate([g[..., : M + 1], zeros, g[..., M + 1:]],
                               axis=-1)
        return self.cht.inverse(full)

    def forward(self, density):
        return self._apply(self.hankel.forward, density)

    def inverse(self, amplitude):
        return self._apply(self.hankel.inverse, amplitude)

    def forward_and_roundtrip(self, density):
        """(FT(ρ), iFT(FT(ρ))) sharing one circular-harmonic analysis."""
        M = self.m_max
        c_full = self.cht.forward(density)
        parts = [c_full[..., : M + 1]] + ([c_full[..., -M:]] if M > 0 else [])
        c = jnp.concatenate(parts, axis=-1)
        cf = self.hankel.forward(c)
        ci = self.hankel.inverse(cf)
        pad = self.n_phi - (2 * M + 1)

        def expand(g):
            zeros = jnp.zeros(g.shape[:-1] + (pad,), dtype=g.dtype)
            return self.cht.inverse(jnp.concatenate(
                [g[..., : M + 1], zeros, g[..., M + 1:]], axis=-1))

        return expand(cf), expand(ci)
