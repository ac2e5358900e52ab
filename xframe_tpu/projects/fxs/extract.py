"""extract worker: cross-correlation data → B_l invariants → projection matrices.

Pipeline (reference projects/fxs/extract.py:38-532, SURVEY.md §3.3):
load ccd.h5 → CC modifications → B_l extraction (back_substitution / lstsq /
circular harmonics in 2D) → PSD enforcement → per-l eigendecomposition into
projection matrices V_l → proj_data.h5. Setup-size float64 host math
(vectorized; no per-order process fan-out as in the reference).
"""
from __future__ import annotations

import numpy as np

from xframe_tpu.interfaces import ProjectWorkerInterface
from xframe_tpu.projects.fxs import invariants as itools
from xframe_tpu.projects.fxs._database_ import ProjectDB


class ProjectWorker(ProjectWorkerInterface):
    database_class = ProjectDB

    def run(self):
        opt = self.settings
        if str(opt.get("extraction_mode", "cross_correlation")) == "shapes":
            data = self.extract_from_shapes()
        else:
            inp = opt.get("input", {})
            run_no = inp.get("ccd_run") or None
            ccd = self.db.load_ccd(run=int(run_no) if run_no else None,
                                   path=inp.get("ccd_path") or None)
            dim = int(ccd.get("dimensions", opt.get("dimensions", 3)))
            data = self.extract(ccd, dim)
        path, run = self.db.save("invariants", data)
        print(f"extract: saved invariants to {path}")
        return data

    # ---------------------------------------------------------------- extract
    def extract(self, ccd, dim):
        opt = self.settings
        qs = np.asarray(ccd["radial_points"], dtype=float)
        wavelength = float(ccd["xray_wavelength"])
        avg_intensity = np.asarray(ccd["average_intensity"], dtype=float)
        L = int(opt.max_order)

        # datasets_to_process: every listed CC dataset present in the file is
        # extracted (reference multi-dataset loop, extract.py:496-532); the
        # projection matrices come from the primary (first) one.
        wanted = [str(n) for n in
                  opt.cross_correlation.get("datasets_to_process", ["I1I1"])]
        present = [n for n in wanted if n in ccd["cross_correlation"]]
        if not present:
            raise ValueError(
                f"none of datasets_to_process {wanted} found in the ccd file "
                f"(has {sorted(ccd['cross_correlation'])})")
        for name in present:
            sh = np.asarray(ccd["cross_correlation"][name]).shape
            if sh[0] != len(qs) or sh[1] != len(qs):
                raise ValueError(
                    f"ccd dataset {name} has radial shape {sh[:2]} but "
                    f"radial_points has {len(qs)} entries — the ccd was "
                    "produced with a restricted qrange_xcca (its "
                    "radial_points stay on the full ring grid, matching the "
                    "reference format); invariant extraction needs a full "
                    "square C(q1,q2,Δ) — re-run correlate without "
                    "qrange_xcca")
        inv_opt = opt.get("invariant_constraints", {})
        apply_psd = bool(inv_opt.get("positive_semidefinite", {})
                         .get("apply", True))
        bls, mask_dict, qlim_dict = {}, {}, {}
        for name in present:
            bl, mask_dict[name], qlim_dict[name] = self._extract_bl(
                ccd, name, dim, qs, wavelength, avg_intensity, L)
            # mixed invariants (I2I1 = V2 U V1†) are not Hermitian-PSD; only
            # the same-dataset B_l are. PSD is enforced on each order's
            # q-limit sub-block only (reference apply_invariant_constraints,
            # extract.py:417-430). A per-dataset bl_enforce_psd key
            # (reference datasets.<name>.bl_enforce_psd) overrides the
            # global invariant_constraints flag.
            ds_psd = opt.cross_correlation.get("datasets", {}) \
                .get(name, {}).get("bl_enforce_psd", None)
            apply_psd_ds = apply_psd if ds_psd is None else bool(ds_psd)
            if apply_psd_ds and name != "I2I1" and dim == 3:
                bl = itools.apply_psd_on_q_limits(bl, qlim_dict[name])
            elif apply_psd_ds and name != "I2I1":
                bl = itools.nearest_positive_semidefinite_matrix(bl)
            bls[name] = bl
        primary = present[0]
        out, proj1, eig1 = self._invariants_to_output(
            bls[primary], dim, qs, wavelength, avg_intensity,
            np.asarray(ccd["angular_points"]),
            q_limits=qlim_dict.get(primary))
        out["deg_2_invariant"] = {n: bls[n] for n in present}
        out["deg_2_invariant_masks"] = {n: mask_dict[n] for n in present}
        # per-order relative error of the rank-capped factorization
        # (reference calc_projection_matrix_error_estimate, extract.py:447,458)
        out["data_projection_matrix_error_estimates"] = {
            primary: itools.projection_matrix_error_estimate(
                bls[primary], proj1)} if dim == 3 else {}

        # --- secondary datasets: I2I2 projection matrices, I2I1 unknown
        # unitary between the two datasets' unknowns (reference
        # extract.py:452-466 → fxs_invariant_tools.py:1297-1436)
        if dim == 3 and "I2I2" in bls and primary != "I2I2":
            rank_cap = bool(opt.get("projection_matrices", {})
                            .get("rank_cap", True))
            proj2, eig2 = itools.deg2_invariant_to_projection_matrices(
                bls["I2I2"], q_id_limits=qlim_dict.get("I2I2"),
                rank_cap=rank_cap)
            out["data_projection_matrices"]["I2I2"] = proj2
            out["data_projection_matrix_error_estimates"]["I2I2"] = \
                itools.projection_matrix_error_estimate(bls["I2I2"], proj2)
            if "I2I1" in bls:
                # reference key (typo included): extract.py:466
                method = str(opt.get(
                    "I2I1_unknown_tranrform_extraction_method", None)
                    or opt.get("unknown_transform", {})
                    .get("method", "procrustes"))
                W, w_err = itools.calc_unknown_unitary_transform(
                    proj1, eig1, proj2, eig2, bls["I2I1"], qs, method=method)
                out["data_projection_matrices"]["I2I1"] = W
                out["data_projection_matrix_error_estimates"]["I2I1"] = w_err

        # --- FQC between two CC datasets (classical per-q coherence,
        # reference resolution_metrics.py:112-144)
        fqc_opt = opt.get("resolution_metrics", {}).get("FQC", {})
        if bool(fqc_opt.get("apply", False)):
            pair = [str(n) for n in fqc_opt.get("datasets", present[:2])]
            if len(pair) >= 2 and all(p in ccd["cross_correlation"]
                                      for p in pair[:2]):
                from xframe_tpu.projects.fxs import resolution_metrics as rm
                f_q, f_2d = rm.fqc(
                    np.asarray(ccd["cross_correlation"][pair[0]], dtype=float),
                    np.asarray(ccd["cross_correlation"][pair[1]], dtype=float),
                    skip_odd_orders=bool(fqc_opt.get("skip_odd_orders", True)),
                    max_order=L)
                out["fqc"] = {"datasets": "_".join(pair[:2]),
                              "curve": f_q, "q1q2": f_2d}
        return out

    # --------------------------------------------------- shapes ground truth
    def extract_from_shapes(self):
        """extraction_mode='shapes': B_l straight from an analytic shape
        density — ground-truth invariants for validating reconstructions,
        no cross-correlation involved (reference extract_bl_from_shapes,
        extract.py:170-243)."""
        import jax
        import jax.numpy as jnp
        from xframe_tpu.library.shapes import spherical_grid, polar_grid
        from xframe_tpu.projects.fxs.simulate_ccd import \
            build_density_from_shapes
        opt = self.settings
        dim = int(opt.get("dimensions", 3))
        sh = opt.shapes_source
        N = int(sh.grid.n_radial_points)
        L = int(opt.max_order)
        q_max = float(sh.grid.max_q)
        mode = str(sh.fourier_transform.type)
        rc = float(sh.fourier_transform.reciprocity_coefficient)
        wavelength = float(sh.xray_wavelength)
        if dim == 3:
            from xframe_tpu.ops.fourier import SphericalFourierTransform
            from xframe_tpu.projects.fxs.reconstruct import \
                load_cached_weights
            ft = SphericalFourierTransform(
                N, L, q_max=q_max, mode=mode, reciprocity_coefficient=rc,
                weights_dict=load_cached_weights(L, N, rc, 3, mode))
            grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
            density = build_density_from_shapes(grid, sh.shapes)

            @jax.jit
            def coeff_fn(rho):
                psi = ft.forward(rho.astype(jnp.complex64))
                return ft.sht.forward_real((psi * psi.conj()).real)

            coeff = np.asarray(coeff_fn(np.asarray(density, dtype=np.float32)))
            bl = np.einsum("qml,pml->lqp", coeff, coeff.conj()).real \
                .astype(complex)
            bl[1::2] = 0  # Friedel symmetry of |F|²
            avg_intensity = coeff[:, L, 0].real / (2 * np.sqrt(np.pi))
            angular = ft.sht.phi
        else:
            from xframe_tpu.ops.fourier import PolarFourierTransform
            n_phi = int(sh.grid.get("n_phi") or 0) or \
                2 ** int(np.ceil(np.log2(2 * (L + 1))))
            ft = PolarFourierTransform(N, L, n_phi, q_max, mode=mode,
                                       reciprocity_coefficient=rc)
            grid = polar_grid(ft.rs, 2 * np.pi * np.arange(n_phi) / n_phi)
            density = build_density_from_shapes(grid, sh.shapes)
            intensity = np.asarray(jax.jit(
                lambda r: (lambda p: (p * p.conj()).real)(
                    ft.forward(r.astype(jnp.complex64))))(
                    np.asarray(density, dtype=np.float32))).astype(np.float64)
            cm = np.fft.fft(intensity, axis=-1)[:, : L + 1] / n_phi
            bl = itools.harmonic_coeff_to_deg2_invariants_2d(cm)
            bl[1::2] = 0
            avg_intensity = np.real(np.fft.fft(intensity, axis=-1)[:, 0]) \
                / n_phi
            angular = 2 * np.pi * np.arange(n_phi) / n_phi
        out, _, _ = self._invariants_to_output(bl, dim, np.asarray(ft.qs),
                                         wavelength, avg_intensity, angular)
        out["deg_2_invariant"] = {"I1I1": bl}
        out["deg_2_invariant_masks"] = {"I1I1": np.ones(bl.shape, dtype=bool)}
        return out

    def _extract_bl(self, ccd, name, dim, qs, wavelength, avg_intensity, L):
        """CC dataset → B_l coefficients (mask, modifications, extraction)."""
        opt = self.settings
        datasets = opt.cross_correlation.datasets
        # unlisted datasets inherit the primary dataset's options
        ds_opt = datasets.get(name) or datasets.get("I1I1", {})
        cc = np.asarray(ccd["cross_correlation"][name], dtype=float)
        zero_odd = bool(ds_opt.get("assume_zero_odd_orders", True))
        method = str(ds_opt.get("bl_extraction_method", "back_substitution"))

        # --- CC mask (reference cross_correlation_mask :100-232)
        phis = np.asarray(ccd["angular_points"], dtype=float)
        mask_opt = ds_opt.get("cc_mask", {})
        mask_type = str(mask_opt.get("type", "none"))
        # the reference nests per-type parameters in a subtree named after
        # the type (cc_mask.pixel_arc.pixel_size, ...); accept both that
        # shape and this rebuild's flat keys
        sub = mask_opt.get(mask_type, {})
        mask_eff = {**{k: mask_opt[k] for k in mask_opt},
                    **({k: sub[k] for k in sub}
                       if hasattr(sub, "__getitem__") and not
                       isinstance(sub, (str, list)) else {})}
        mask = itools.cc_mask(
            qs, phis, mask_type=mask_type, xray_wavelength=wavelength,
            pixel_size=mask_eff.get("pixel_size"),
            mask_at_pi=bool(mask_eff.get("mask_at_pi", True)),
            threshold=float(mask_eff.get("threshold", 0.01)),
            n_masked_pixels_phi=float(mask_eff.get("n_masked_pixels_phi", 0.0)
                                      or 0.0),
            n_masked_pixels_q=float(mask_eff.get("n_masked_pixels_q",
                                    mask_eff.get("n_masked_q1q2", 0.0))
                                    or 0.0),
            custom=mask_eff.get("mask")) if dim == 3 else \
            np.ones(cc.shape, dtype=bool)

        # --- CC modifications (reference modify_cross_correlation :235-289)
        mod = ds_opt.get("modify_cc", {})
        subtracted_avg = bool(mod.get("subtract_average_intensity", True))
        if subtracted_avg:
            if dim == 3:
                # a(q1)a(q2) is exactly the B_0 term of the CC (n=0 in Δ)
                cc = cc - np.asarray(avg_intensity)[:, None, None] \
                    * np.asarray(avg_intensity)[None, :, None]
            else:
                cc = cc - avg_intensity[:, None, None] * avg_intensity[None, :, None]
        lpq = mod.get("low_pass_order_in_q", False)
        if lpq:
            cc = itools.low_pass_cc_in_q(cc, float(lpq))
        lp = mod.get("low_pass_order", False)
        if lp or mod.get("enforce_max_order", False) \
                or mod.get("zero_odd_harmonics", False):
            # enforce_max_order caps at the grid L (reference
            # fxs_invariant_tools.py:254-260); an explicit low_pass_order
            # tightens but cannot loosen that cap
            caps = ([int(lp)] if lp else []) \
                + ([L] if mod.get("enforce_max_order", False) else [])
            cc = itools.zero_cc_harmonics(
                cc, max_order=min(caps) if caps else None,
                zero_odd=bool(mod.get("zero_odd_harmonics", False)))
        if mod.get("q1q2_symmetrize", False):
            cc, mask = itools.symmetrize_cc_q1q2(cc, mask)
        if mod.get("pi_periodicity", False):
            cc, mask = itools.enforce_pi_periodicity(cc, mask)
        if mod.get("binned_mean", False):
            cc, mask, phis = itools.binned_mean_cc(cc, mask, L, phis)
        if not mask.all():
            if mod.get("interpolate_masked", True):
                cc = itools.interpolate_masked_cc(cc, mask)
            else:
                cc = np.where(mask, cc, 0.0)

        # --- B_l extraction
        if dim == 3:
            bl = itools.cc_to_deg2_invariant_3d(
                cc, wavelength, qs, L, assume_zero_odd_orders=zero_odd,
                mode=method)
            if subtracted_avg:
                # re-insert B_0 from the averaged intensity:
                # B_0 = I_00 I_00* = 4π a(q1) a(q2)
                bl[0] = 4 * np.pi * np.outer(avg_intensity, avg_intensity)
        else:
            bl = itools.cc_to_deg2_invariant_2d(cc, L)
            if subtracted_avg:
                bl[0] = np.outer(avg_intensity, avg_intensity)

        # --- per-order q-limit line masks (reference extract.py:332-414)
        bl_mask, qlim = self._bl_masks(ds_opt, qs, L)
        return bl, bl_mask, qlim

    def _bl_masks(self, ds_opt, qs, L):
        """Dataset bl_q_limits → (mask (L+1,n_q,n_q), q_id_limits (L+1,2)).
        'line' limits bound each order's usable q range; 'manual' global
        limits (invariant_constraints.q_limits) apply otherwise."""
        lim_opt = ds_opt.get("bl_q_limits", {})

        def _line(side):
            s = lim_opt.get(side, {})
            if str(s.get("type", "none")) == "line":
                pts = s.get("line")
                return (tuple(float(v) for v in pts[0]),
                        tuple(float(v) for v in pts[1]))
            return None
        min_line, max_line = _line("min"), _line("max")
        if min_line is None and max_line is None:
            qlim = np.asarray(self._q_id_limits(L + 1, len(qs)))
            mask = np.zeros((L + 1, len(qs), len(qs)), dtype=bool)
            for l in range(L + 1):
                lo, hi = qlim[l]
                mask[l, lo:hi, lo:hi] = True
            return mask, qlim
        return itools.line_q_id_limits(qs, L, min_line=min_line,
                                       max_line=max_line)

    def _invariants_to_output(self, bl, dim, qs, wavelength, avg_intensity,
                              angular_points, q_limits=None):
        """Shared tail: projection matrices → prephasing → output schema.
        Callers pass PSD-enforced (or by-construction PSD) invariants."""
        opt = self.settings
        if q_limits is None:
            q_limits = self._q_id_limits(bl.shape[0], len(qs))

        # --- projection matrices (reference extract.py:433-466); eigen-pair
        # ranking per bl_eig_sort_mode (reference extract.py:436-440)
        sort_mode = 1 if str(opt.get("bl_eig_sort_mode", "eigenvalue")) \
            == "median_of_scaled_eigenvector" else 0
        if dim == 3:
            rank_cap = bool(opt.get("projection_matrices", {})
                            .get("rank_cap", True))
            proj, eigs = itools.deg2_invariant_to_projection_matrices(
                bl, q_id_limits=q_limits, rank_cap=rank_cap,
                sort_mode=sort_mode)
        else:
            vecs, eigs = itools.deg2_invariant_to_projection_vectors_2d(
                bl, sort_mode=sort_mode)
            proj = [v[:, None] for v in vecs]

        # --- optional prephasing: SHT positivity constraint on V_l
        # (reference extract.py:479-493 → fxs_invariant_tools.py:1271)
        pp = opt.get("projection_matrices", {}).get("prephase", {})
        if dim == 3 and bool(pp.get("apply", False)):
            from xframe_tpu.ops.sht import SphericalHarmonicTransform
            sht = SphericalHarmonicTransform(bl.shape[0] - 1)
            proj, converged = itools.enforce_sht_constraint(
                proj, sht, iterations=int(pp.get("iterations", 10)) * 10)
            print(f"extract: prephasing "
                  f"{'converged' if converged else 'ran its iteration budget'}")

        # --- particle number: assumed value or estimated from the projection
        # matrices' negative-intensity onset (reference extract settings
        # n_particles + fxs_invariant_tools.py:1583-1860)
        pn_opt = opt.get("number_of_particles", {})
        n_particles = float(pn_opt.get("value", 1))
        if dim == 3 and bool(pn_opt.get("estimate", {}).get("apply", False)):
            eopt = pn_opt.get("estimate", {})
            from xframe_tpu.ops.sht import SphericalHarmonicTransform
            sht_pn = SphericalHarmonicTransform(bl.shape[0] - 1)
            n_particles, _, _, _ = itools.estimate_number_of_particles(
                proj, sht_pn,
                search_space=tuple(eopt.get("search_space", [1.0, 10.0, 64])),
                average_intensity=avg_intensity,
                method=str(eopt.get("method", "onset")))
            print(f"extract: estimated number_of_particles = {n_particles:.3g}")

        # --- low-resolution intensity coefficients: the first
        # low-res orders of V_l, optionally SHT-positivity-optimized
        # (reference extract.py calc_low_resolution_intensity_coefficients
        # + settings low_resolution_intensity_approximation /
        # optimize_projection_matrices). Consumed by reconstruct's
        # 'low_resolution_autocorrelation' density guess. With max_order=0
        # (default) only the isotropic I_00 = a(q)·2√π column is stored.
        lr_opt = opt.get("low_resolution_intensity_approximation", {})
        lr_max = min(int(lr_opt.get("max_order", 0)), bl.shape[0] - 1)
        if dim == 3 and lr_max > 0:
            lr = [np.asarray(p).copy() for p in proj[: lr_max + 1]]
            if bool(opt.get("optimize_projection_matrices", {})
                    .get("use", False)):
                from xframe_tpu.ops.sht import SphericalHarmonicTransform
                sht_lr = SphericalHarmonicTransform(lr_max)
                lr, _ = itools.enforce_sht_constraint(
                    lr, sht_lr,
                    iterations=int(lr_opt.get("n_iterations", 100)),
                    rel_err_limit=float(lr_opt.get("error_change_limit",
                                                   1e-5)))
            low_res = {str(l): np.asarray(v) for l, v in enumerate(lr)}
        else:
            low_res = avg_intensity * 2 * np.sqrt(np.pi)
        out = {
            "dimensions": dim,
            "xray_wavelength": wavelength,
            "max_order": bl.shape[0] - 1,
            "average_intensity": avg_intensity,
            "data_radial_points": qs,
            "data_angular_points": np.asarray(angular_points),
            "data_projection_matrices": {"I1I1": proj},
            "data_projection_matrices_q_id_limits": np.asarray(q_limits),
            "data_low_resolution_intensity_coefficients": low_res,
            "number_of_particles": n_particles,
        }
        return out, proj, eigs

    def _q_id_limits(self, n_orders, n_q):
        ql = self.settings.get("invariant_constraints", {}).get("q_limits", {})
        if str(ql.get("type", "none")) == "manual":
            lo, hi = ql["manual"]["limits"]
            hi = int(hi) if hi else n_q
            return [[int(lo), hi]] * n_orders
        return [[0, n_q]] * n_orders
