"""simulate_ccd worker: synthetic cross-correlation dataset from analytic shapes.

Pipeline (reference projects/fxs/simulate_ccd.py:92-..., SURVEY.md §3):
density from shapes → spherical FT → intensity → harmonic coefficients →
B_l → C(q1,q2,Δ) on the Ewald-curvature-aware grid → ccd.h5 compatible with
the extract worker. The FT/SHT run jitted on device; the invariant synthesis
is setup-size host math.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from xframe_tpu.interfaces import ProjectWorkerInterface
from xframe_tpu.library.shapes import (spherical_grid, polar_grid, SHAPE_BUILDERS)
from xframe_tpu.ops.fourier import SphericalFourierTransform, PolarFourierTransform
from xframe_tpu.projects.fxs import invariants as itools
from xframe_tpu.projects.fxs._database_ import ProjectDB


def _shape_specs(shapes_opt, grid_dim, rng=None):
    """Normalize the shapes settings block to per-shape host constants:
    (type, cartesian center, size, amplitude, rotation|None). The rotation
    draws consume the SAME rng stream in the same order as the numpy
    builders, so host and device paths agree bit-for-bit on seeds."""
    from scipy.stats import special_ortho_group
    from xframe_tpu.library.shapes import spherical_to_cartesian
    types = list(shapes_opt["types"])
    centers = list(shapes_opt["centers"])
    sizes = list(shapes_opt["sizes"])
    amplitudes = list(shapes_opt["densities"])
    randoms = list(shapes_opt.get("random_orientation", [False] * len(types)))
    specs = []
    for typ, center, size, amp, rnd in zip(types, centers, sizes, amplitudes,
                                           randoms):
        center = np.asarray(center, dtype=float)
        if grid_dim == 2 and center.size == 3:
            center = center[[0, 2]]
        elif center.size != grid_dim:
            raise ValueError(
                f"shape center {center.tolist()} has {center.size} "
                f"coordinates but the {grid_dim}D grid expects {grid_dim} "
                f"({'r, phi' if grid_dim == 2 else 'r, theta, phi'})")
        rot = None
        if rnd:
            r = rng or np.random.default_rng()
            rot = special_ortho_group.rvs(grid_dim, random_state=r)
        specs.append((str(typ), spherical_to_cartesian(center),
                      float(np.asarray(size).ravel()[0]), float(amp), rot))
    return specs


def device_density_from_shapes(axes, shapes_opt, rng=None):
    """Superpose the configured shapes directly ON DEVICE from the 1D grid
    axes — the cartesian coordinates are broadcast expressions XLA fuses
    into the mask evaluation, so the 67M-point cartesian grid the host
    builder materializes (the simulate_ccd wall-clock hog: 200-280 s of
    single-core numpy trig at the tutorial's 512x258x512 grid) never exists.
    axes: (rs, thetas, phis) for 3D or (rs, phis) for polar 2D. Returns a
    float32 device array; shape semantics identical to
    build_density_from_shapes (reference simulate_ccd.py:92-123 +
    mathLibrary SampleShapeFunctions:103-320)."""
    import jax
    from xframe_tpu.library.shapes import _tetrahedron_planes
    dim = len(axes)
    specs = _shape_specs(shapes_opt, dim, rng)
    axes = tuple(np.asarray(a, dtype=np.float32) for a in axes)

    @jax.jit
    def build(*ax):
        if dim == 3:
            rs, th, ph = ax
            r = rs[:, None, None]
            sin_t, cos_t = jnp.sin(th)[None, :, None], jnp.cos(th)[None, :, None]
            cos_p, sin_p = jnp.cos(ph)[None, None, :], jnp.sin(ph)[None, None, :]
            coords = (r * sin_t * cos_p, r * sin_t * sin_p,
                      jnp.broadcast_to(r * cos_t, (rs.size, th.size, ph.size)))
        else:
            rs, ph = ax
            r = rs[:, None]
            coords = (r * jnp.cos(ph)[None, :], r * jnp.sin(ph)[None, :])
        shape = coords[0].shape
        density = jnp.zeros(shape, jnp.float32)
        for typ, center, size, amp, rot in specs:
            c = [x - jnp.float32(cc) for x, cc in zip(coords, center)]
            if rot is not None:
                # numpy path applies cart @ rot: out_j = sum_i c_i rot[i, j]
                c = [sum(c[i] * jnp.float32(rot[i, j]) for i in range(dim))
                     for j in range(dim)]
            if typ in ("sphere", "ball"):
                mask = sum(x * x for x in c) < jnp.float32(size * size)
            elif typ == "cube":
                half = jnp.float32(size / 2)
                mask = jnp.ones(shape, bool)
                for x in c:
                    mask &= jnp.abs(x) < half
            elif typ == "tetrahedron":
                mask = jnp.ones(shape, bool)
                for base, normal in _tetrahedron_planes(size):
                    d = jnp.float32(base @ normal) - sum(
                        x * jnp.float32(n) for x, n in zip(c, normal))
                    mask &= d >= 0
            else:
                raise ValueError(f"unknown shape type {typ!r}")
            density = density + jnp.where(mask, jnp.float32(amp), 0.0)
        return density

    return build(*axes)


def build_density_from_shapes(grid, shapes_opt, rng=None):
    """Superpose the configured shapes on a (r,θ,φ) or (r,φ) grid; a 'pdb'
    entry smears a deposited structure onto the grid (library.pdb)."""
    density = np.zeros(grid.shape[:-1])
    if str(shapes_opt.get("types", [""])[0]) == "pdb":
        from xframe_tpu.library import pdb as pdb_io
        from xframe_tpu.library.shapes import spherical_to_cartesian
        src = str(shapes_opt.get("map_file") or shapes_opt["pdb_file"])
        if pdb_io.is_map_file(src):
            # experimental density from a local CCP4/MRC map (e.g. a
            # downloaded 2Fo-Fc map — the reference's pdb_eda input,
            # pdb_plugin.py:38-46, without the network dependency)
            cart = spherical_to_cartesian(grid)
            if cart.shape[-1] == 2:            # 2D polar grid: z = 0 slice
                cart = np.concatenate(
                    [cart, np.zeros(cart.shape[:-1] + (1,))], axis=-1)
            return pdb_io.map_density(src, cart)
        return pdb_io.pdb_density(
            src, spherical_to_cartesian(grid),
            resolution=float(shapes_opt.get("resolution", 4.0)))
    types = list(shapes_opt["types"])
    centers = list(shapes_opt["centers"])
    sizes = list(shapes_opt["sizes"])
    amplitudes = list(shapes_opt["densities"])
    randoms = list(shapes_opt.get("random_orientation", [False] * len(types)))
    # one spherical→cartesian conversion shared by every shape: the trig over
    # the full grid dominates at simulation scale (67M points for the
    # tutorial's N=512), and float32 halves its memory traffic without
    # affecting the binary shape masks
    from xframe_tpu.library.shapes import spherical_to_cartesian
    cart = spherical_to_cartesian(
        np.asarray(grid, dtype=np.float32)).astype(np.float32)
    grid_dim = grid.shape[-1]
    for typ, center, size, amp, rnd in zip(types, centers, sizes, amplitudes,
                                           randoms):
        builder = SHAPE_BUILDERS[str(typ)]
        center = np.asarray(center, dtype=float)
        if grid_dim == 2 and center.size == 3:
            # dimensions: 2 with the 3D default/spherical (r, θ, φ) centers
            # (the shipped default is [0, 0, 0]): take the polar (r, φ)
            # reading instead of crashing on the shape mismatch
            center = center[[0, 2]]
        elif center.size != grid_dim:
            raise ValueError(
                f"shape center {center.tolist()} has {center.size} "
                f"coordinates but the {grid_dim}D grid expects {grid_dim} "
                f"({'r, phi' if grid_dim == 2 else 'r, theta, phi'})")
        density += builder(grid, float(np.asarray(size).ravel()[0]),
                           center=center,
                           amplitude=float(amp), random_orientation=bool(rnd),
                           rng=rng, cart=cart)
    return density


class ProjectWorker(ProjectWorkerInterface):
    database_class = ProjectDB

    def run(self):
        opt = self.settings
        dim = int(opt.dimensions)
        self._model = None
        if dim == 3:
            data = self._run_3d(opt)
        else:
            data = self._run_2d(opt)
        path, run = self.db.save("ccd", data)
        # model-density vtk next to the ccd (reference ccd options
        # save_model_vtk, simulate_ccd default_0.01.yaml:129-131)
        if bool(self.db._io_option("ccd", "save_model_vtk", True)) \
                and self._model is not None and dim == 3:
            try:
                import os
                from xframe_tpu.io import vtk as vtk_io
                density, (rs, thetas, phis) = self._model
                # cap the viz artifact: at the tutorial's 512×256×512 grid a
                # full-resolution .vts is ~1.4 GB of base64 and minutes of
                # host time; stride each axis down to ~max_points total
                # (IO.files.ccd.options.model_vtk_max_points, 0 = full).
                # Stride BEFORE readback — the model may be device-resident
                # (device_density_from_shapes) and the strided subset is
                # ~8 MB vs 268 MB.
                cap = int(self.db._io_option("ccd", "model_vtk_max_points",
                                             2_000_000) or 0)
                if cap and density.size > cap:
                    s = int(np.ceil((density.size / cap) ** (1 / 3)))
                    density = density[::s, ::s, ::s]
                    rs, thetas, phis = rs[::s], thetas[::s], phis[::s]
                density = np.asarray(density)
                vtk_io.save_spherical(
                    os.path.join(os.path.dirname(path), "model_density.vts"),
                    rs, thetas, phis, {"density": density})
            except Exception:
                pass
        print(f"simulate_ccd: saved synthetic CC dataset to {path}")
        return data

    # ------------------------------------------------------------------- 3D
    def _run_3d(self, opt):
        from xframe_tpu.logger import Timer, xprint
        N = int(opt.grid.n_radial_points)
        L = int(opt.grid.max_order)
        q_max = self._resolve_max_q(opt, N)
        wavelength = float(opt.cross_correlation.xray_wavelength)
        mode = str(opt.fourier_transform.type)
        rc = float(opt.fourier_transform.reciprocity_coefficient)

        # Hankel weights through the shared disk cache (reference
        # fourier_transforms.py:17-35 caches them keyed by N/L/rc/mode;
        # generation is ~47 s host-side at the tutorial's N=512, L=128).
        from xframe_tpu.projects.fxs.reconstruct import load_cached_weights
        with Timer("weights+transforms", report=xprint) as _:
            ft = SphericalFourierTransform(
                N, L, q_max=q_max, mode=mode, reciprocity_coefficient=rc,
                weights_dict=load_cached_weights(L, N, rc, 3, mode),
                n_theta=int(opt.grid.get("n_theta", 0) or 0) or None,
                n_phi=int(opt.grid.get("n_phi_internal", 0) or 0) or None)
        import jax
        with Timer("density from shapes", report=xprint):
            if str(opt.shapes.get("types", [""])[0]) == "pdb":
                # deposited-structure smearing is host-side (library.pdb);
                # only this path needs the materialized spherical grid
                grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
                density = build_density_from_shapes(grid, opt.shapes)
            else:
                # analytic shapes evaluate on device from the 1D axes —
                # the host path's 200-280 s of single-core trig over the
                # 67M-point grid becomes one fused elementwise program
                density = device_density_from_shapes(
                    (ft.rs, ft.sht.theta, ft.sht.phi), opt.shapes)
                jax.block_until_ready(density)
        self._model = (density, (ft.rs, ft.sht.theta, ft.sht.phi))

        # one jitted program: density → intensity coefficients. The Hankel
        # weights enter as ARGUMENTS, not constants — at simulation grids
        # (N=512, L=128 ⇒ 270 MB table) embedded constants would bloat the
        # program (hankel.weight_planes). The density is already
        # device-resident; coeff/B_l stay on device too — only the final CC
        # grid, one intensity column, and the (strided) model come back to
        # the host.
        from xframe_tpu.ops.hankel import weight_planes, apply_hankel_planes

        (wf_re, wf_im), _ = weight_planes(ft.hankel)
        skip_zero = ft.hankel.skip_zero

        @jax.jit
        def intensity_coeff(rho_real, w_re, w_im):
            c = ft.sht.forward(rho_real.astype(jnp.complex64))
            F = apply_hankel_planes(w_re, w_im, c, skip_zero)
            psi = ft.sht.inverse(F)
            return ft.sht.forward_real((psi * psi.conj()).real)

        with Timer("intensity coefficients (incl. compile)", report=xprint):
            coeff = intensity_coeff(
                density.astype(jnp.float32) if hasattr(density, "astype")
                else np.asarray(density, dtype=np.float32), wf_re, wf_im)
            jax.block_until_ready(coeff)
        # B_l = I_l I_l† on device (O(L·n_q²·n_m) — minutes in numpy at
        # production grids, sub-second on the device), with the Friedel
        # odd-order kill (symmetry of |F|² makes them exactly 0) and the
        # N-dilute-particle scaling (every B_l scales by N, the l=0
        # mean-intensity invariant by N²; reference simulate_ccd.py:208-213
        # `bl*=N; bl[0]*=N`) folded into the same program
        n_part = float(opt.get("n_particles", 1) or 1)

        @jax.jit
        def bl_from_coeff(c):
            bl = jnp.einsum("qml,pml->lqp", c, c.conj(),
                            precision=jax.lax.Precision.HIGHEST).real
            ls = jnp.arange(bl.shape[0])
            scale = jnp.where(ls == 0, n_part * n_part,
                              jnp.where(ls % 2 == 1, 0.0, n_part))
            return bl * scale[:, None, None].astype(bl.dtype)

        with Timer("B_l from coefficients (incl. compile)", report=xprint):
            bl = bl_from_coeff(coeff)
            jax.block_until_ready(bl)

        n_phi = int(opt.grid.get("n_phi") or 0)
        if n_phi <= 0:
            n_phi = 2 ** int(np.ceil(np.log2(2 * (L + 1))))
        with Timer("CC synthesis (incl. compile)", report=xprint):
            cc = self._synthesize_cc_device(bl, wavelength, ft.qs, n_phi)

        cc = self._apply_noise(cc, opt)
        # angular mean of the intensity: a(q) = I_00(q)·Y_00 = I_00/(2√π);
        # consistent with the scaled invariants: √(diag B_0·N²) = N·a(q)
        avg_intensity = n_part * np.asarray(
            coeff[:, L, 0]).real / (2 * np.sqrt(np.pi))
        return {
            "dimensions": 3,
            "radial_points": ft.qs,
            "angular_points": 2 * np.pi * np.arange(n_phi) / n_phi,
            "xray_wavelength": wavelength,
            "average_intensity": avg_intensity,
            "cross_correlation": {"I1I1": cc.real},
            "num_images_processed": 1,
            "num_images_good": 1,
        }

    def _apply_noise(self, cc, opt):
        """Optional additive noise on the synthetic CC: per-(q1,q2) scale set
        by that pair's CC magnitude over Δ (a finite-photon-statistics
        stand-in; `noise: {apply: true, snr: X}`)."""
        nopt = opt.get("noise", {})
        if not bool(nopt.get("apply", False)):
            return cc
        snr = float(nopt.get("snr", 100.0))
        rng = np.random.default_rng(int(nopt.get("seed", 0)))
        scale = np.abs(cc).std(axis=-1, keepdims=True) / snr
        noisy = cc + rng.normal(size=cc.shape) * scale
        # preserve the exact q1<->q2 symmetry of a true CC
        return 0.5 * (noisy + np.swapaxes(noisy, 0, 1))

    def _synthesize_cc_device(self, bl, wavelength, qs, n_phi):
        """C_n = Σ_l B_l · P̄ⁿ_l(θ1)P̄ⁿ_l(θ2)/(2l+1) per-l on device (a
        three-tensor einsum would materialize a (q,p,n,l) intermediate —
        terabytes at production grids). The Legendre table enters as a jit
        ARGUMENT — at production grids it exceeds the embeddable-constant
        size. `bl` may be a device-resident real f32 array (the chained
        worker path) or a host complex array.

        Only the q1≤q2 triangle of the C_n HALF-SPECTRUM comes back to the
        host — C_n inherits B_l's exact (q1,q2) symmetry (Re of a Hermitian
        Gram matrix) and the Δ axis is an irfft expansion, so the (pairs, n)
        packed array carries the full information in ~1/8 of the CC grid's
        bytes (68 vs 537 MB at the tutorial's 512³). The unpack + irfft run
        on the host."""
        import jax
        from xframe_tpu.library.physics import ewald_sphere_theta_pi
        from xframe_tpu.library.legendre import sph_legendre_table

        L = bl.shape[0] - 1
        thetas = ewald_sphere_theta_pi(wavelength, np.asarray(qs))
        T = sph_legendre_table(L, np.cos(thetas)).astype(np.float32)  # (q,n,l)
        scale = (1.0 / (2 * np.arange(L + 1) + 1)).astype(np.float32)
        n_q = T.shape[0]
        iu0, iu1 = (a.astype(np.int32) for a in np.triu_indices(n_q))

        @jax.jit
        def synth(bls, tab, i0, i1):
            bls = bls * scale[:, None, None].astype(bls.dtype)
            n_n = tab.shape[1]

            def body(l, cns):
                col = tab[:, None, :, l] * tab[None, :, :, l]   # (q,p,n)
                return cns + bls[l][:, :, None] * col

            cns = jax.lax.fori_loop(
                0, bls.shape[0], body,
                jnp.zeros((n_q, n_q, n_n), dtype=bls.dtype))
            return cns[i0, i1, :]                               # (pairs, n)

        if not (isinstance(bl, jnp.ndarray) and bl.dtype == jnp.float32):
            bl = np.ascontiguousarray(np.asarray(bl).real, dtype=np.float32)
        packed = np.asarray(synth(bl, T, iu0, iu1))
        cns = np.empty((n_q, n_q, packed.shape[-1]), np.float32)
        cns[iu0, iu1] = packed
        cns[iu1, iu0] = packed
        return np.fft.irfft(
            cns.astype(np.float64) * n_phi, n_phi, axis=-1).astype(np.float32)

    # ------------------------------------------------------------------- 2D
    def _resolve_max_q(self, opt, n_radial):
        """grid.max_q: False derives q_max from grid.oversampling × the
        outermost shape extent via the reciprocity relation (reference
        simulate_ccd.py:109-123); a number is taken as-is."""
        mq = opt.grid.get("max_q", False)
        if not isinstance(mq, bool) and mq:
            return float(mq)
        over = float(opt.grid.get("oversampling", 8))
        shp = opt.shapes
        centers = np.atleast_2d(np.asarray(shp.centers, dtype=float))
        sizes = np.asarray(shp.sizes, dtype=float)
        size_given = shp.get("shape_size", "not given")
        if isinstance(size_given, (int, float)):
            max_particle_radius = float(size_given) / 2
        else:
            max_particle_radius = float((centers[:, 0] + sizes).max())
        from xframe_tpu.ops.hankel import reciprocity_relation
        rc = float(opt.fourier_transform.reciprocity_coefficient)
        return reciprocity_relation(over * max_particle_radius, n_radial, rc)

    def _run_2d(self, opt):
        N = int(opt.grid.n_radial_points)
        M = int(opt.grid.max_order)
        q_max = self._resolve_max_q(opt, N)
        mode = str(opt.fourier_transform.type)
        rc = float(opt.fourier_transform.reciprocity_coefficient)
        n_phi = int(opt.grid.get("n_phi") or 0)
        if n_phi <= 0:
            n_phi = 2 ** int(np.ceil(np.log2(2 * (M + 1))))

        from xframe_tpu.projects.fxs.reconstruct import load_cached_weights
        ft = PolarFourierTransform(N, M, n_phi, q_max, mode=mode,
                                   reciprocity_coefficient=rc,
                                   weights_dict=load_cached_weights(
                                       M, N, rc, 2, mode))
        phi_axis = 2 * np.pi * np.arange(n_phi) / n_phi
        if str(opt.shapes.get("types", [""])[0]) == "pdb":
            density = build_density_from_shapes(
                polar_grid(ft.rs, phi_axis), opt.shapes)
        else:
            density = device_density_from_shapes((ft.rs, phi_axis),
                                                 opt.shapes)
        import jax
        dens32 = density.astype(jnp.float32) if hasattr(density, "astype") \
            else np.asarray(density, dtype=np.float32)
        intensity = np.asarray(jax.jit(
            lambda r: (lambda p: (p * p.conj()).real)(
                ft.forward(r.astype(jnp.complex64))))(
                dens32)).astype(np.float64)
        coeff = np.fft.fft(intensity, axis=-1) / n_phi  # circular harmonics
        coeff_m = coeff[:, : M + 1]
        bm = itools.harmonic_coeff_to_deg2_invariants_2d(coeff_m)
        bm[1::2] = 0
        # N-particle scaling as in 3D (reference simulate_ccd.py:208-213)
        n_part = float(opt.get("n_particles", 1) or 1)
        bm *= n_part
        bm[0] *= n_part
        cc = itools.deg2_invariant_to_cc_2d(bm, n_phi=n_phi)
        avg_intensity = n_part * coeff[:, 0].real
        return {
            "dimensions": 2,
            "radial_points": ft.qs,
            "angular_points": 2 * np.pi * np.arange(n_phi) / n_phi,
            "xray_wavelength": float(opt.cross_correlation.xray_wavelength),
            "average_intensity": avg_intensity,
            "cross_correlation": {"I1I1": cc.real},
            "num_images_processed": 1,
            "num_images_good": 1,
        }
