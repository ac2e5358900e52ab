"""average worker: align multi-start reconstructions and average them.

Pipeline (reference projects/fxs/average.py:359-626, SURVEY.md §3.4):
load reconstructions (error-filtered) → center each (reciprocal phase ramp) →
normalize → pick lowest-error reference → rotational alignment via SO(3)
correlation of SH coefficients with point-inversion disambiguation → drop bad
alignments (l2 limit) → average → PRTF/FSC resolution metrics →
average_results.h5.

All per-candidate work is BATCHED device code: one vmapped centering call,
one correlation call covering every candidate and its point inverse, one
rotation/synthesis call — no per-candidate host round-trips (the reference
forks a process per candidate; round-2 of this rebuild synced per candidate).
The stored projected reciprocal amplitudes ride along as companion fields and
get the identical shift/inversion/rotation, enabling the data-relative
PRTF_fxs variants (reference average.py:238-263)."""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from xframe_tpu.interfaces import ProjectWorkerInterface
from xframe_tpu.ops.fourier import SphericalFourierTransform
from xframe_tpu.ops.integrate import SphericalIntegrator
from xframe_tpu.projects.fxs._database_ import ProjectDB
from xframe_tpu.projects.fxs.alignment import Aligner
from xframe_tpu.projects.fxs import resolution_metrics as rm


class ProjectWorker(ProjectWorkerInterface):
    database_class = ProjectDB

    def run(self):
        opt = self.settings
        # load_routine: name of the loader method (reference average.py:103
        # dispatches getattr(self, opt['load_routine'])) — subclass hook for
        # custom result formats
        routine = str(opt.get("load_routine", "load_reconstructions"))
        loader = getattr(self, routine, None) \
            or getattr(self, "_" + routine, None)
        if loader is None:
            raise AttributeError(f"unknown load_routine {routine!r}")
        import time
        t0 = time.perf_counter()
        recs, cfg = loader()
        t_load = time.perf_counter() - t0
        densities, psis, errors, meta, masks = self._select(recs)
        if len(densities) == 0:
            raise RuntimeError("no reconstructions pass the selection filter")
        proj_per_file = [r.get("projection_matrices") for r in recs]
        t0 = time.perf_counter()
        result = self.average(densities, psis, errors, cfg, meta,
                              proj_per_file=proj_per_file, masks=masks)
        t_avg = time.perf_counter() - t0
        t0 = time.perf_counter()
        path, run = self.db.save("average_results", result)
        t_save = time.perf_counter() - t0
        result.setdefault("timing", {}).update(
            {"load_s": t_load, "average_s": t_avg, "save_s": t_save})
        print(f"average: aligned {len(result['aligned'])} of {len(densities)} "
              f"reconstructions; saved to {path}")
        print(f"average timing: load {t_load:.1f}s, device+align {t_avg:.1f}s,"
              f" save {t_save:.1f}s")
        return result

    # --------------------------------------------------------------- loading
    def _load_reconstructions(self):
        files = list(self.settings.get("reconstruction_files", []) or [])
        if not files:
            data = [self.db.load_reconstructions()]
        else:
            data = []
            for f in files:
                if isinstance(f, int):
                    data.append(self.db.load_reconstructions(run=f))
                else:
                    data.append(self.db.load_reconstructions(path=str(f)))
        cfg = data[0]["configuration"]
        return data, cfg

    def _select(self, recs):
        sel = self.settings.get("selection", {})
        limit = float(sel.get("error_limit", 1.0))
        n_max = sel.get("n_reconstructions", "all")
        # which error_dict entry ranks/filters candidates (reference
        # selection.error_metric, average.py:632,662); arrays use their
        # final value
        metric = str(sel.get("error_metric", "final"))
        d_lo, d_hi = (sel.get("max_density_range", [None, None])
                      or [None, None])
        densities, psis, masks, errors, meta = [], [], [], [], []
        for fi, rec in enumerate(recs):
            for key, res in rec["reconstruction_results"].items():
                e = np.asarray(res["error_dict"].get(
                    metric, res["error_dict"]["final"]))
                err = float(e.reshape(-1)[-1]) if e.ndim else float(e)
                manual_ids = sel.get("manual_ids", None) or None
                if str(sel.get("method", "least_error")) == "manual" \
                        and manual_ids is not None:
                    # rebuild extension: restrict the candidate set
                    if int(key) not in [int(i) for i in manual_ids]:
                        continue
                elif err > limit:
                    continue
                rho = np.asarray(res["real_density"])
                # validity window on the max density (reference
                # valid_maximal_density, average.py:710-719)
                dmax = float(np.abs(rho.real).max())
                if not isinstance(d_lo, (bool, type(None))) \
                        and dmax < float(d_lo):
                    continue
                if not isinstance(d_hi, (bool, type(None))) \
                        and dmax > float(d_hi):
                    continue
                densities.append(rho)
                psi = res.get("reciprocal_density")
                psis.append(None if psi is None else np.asarray(psi))
                m = res.get("support_mask")
                masks.append(None if m is None else np.asarray(m))
                errors.append(err)
                meta.append({"file_index": fi, "result_key": key, "error": err})
        order = np.argsort(errors)
        if not (isinstance(n_max, str) and n_max == "all"):
            order = order[: int(n_max)]
        # selection.method 'manual' + manual_specifier [file_index, result_id]
        # names the ALIGNMENT REFERENCE (reference get_reference_arg,
        # average.py:701-708); move it to the front of the error-sorted list
        # (average() uses index 0 as the reference).
        if str(sel.get("method", "least_error")) == "manual" \
                and sel.get("manual_specifier") is not None:
            f_spec, k_spec = list(sel["manual_specifier"])[:2]
            pos = [j for j, i in enumerate(order)
                   if meta[i]["file_index"] == int(f_spec)
                   and str(meta[i]["result_key"]) == str(k_spec)]
            if not pos:
                raise RuntimeError(
                    f"selection.manual_specifier {list(sel['manual_specifier'])} "
                    "does not match any loaded reconstruction "
                    "(after error/density filtering)")
            order = np.concatenate(([order[pos[0]]],
                                    np.delete(order, pos[0])))
        if any(p is None for p in psis):
            psis = None          # legacy files without stored amplitudes
        else:
            psis = [psis[i] for i in order]
        masks = None if any(m is None for m in masks) \
            else [masks[i] for i in order]
        return ([densities[i] for i in order],
                psis,
                [errors[i] for i in order],
                [meta[i] for i in order],
                masks)

    # -------------------------------------------------------------- averaging
    def average(self, densities, psis, errors, cfg, meta, proj_per_file=None,
                masks=None):
        opt = self.settings
        grid_cfg = cfg["internal_grid"]
        rs = np.asarray(grid_cfg["real_grid"])
        qs = np.asarray(grid_cfg["reciprocal_grid"])
        thetas = np.asarray(grid_cfg.get("thetas", []))
        phis = np.asarray(grid_cfg["phis"])
        L = int(cfg.get("max_order", len(thetas) - 1))
        rc = float(cfg.get("reciprocity_coefficient", 2.0))

        dim = int(cfg.get("dimensions", 3))
        ft_mode = str(cfg.get("fourier_transform_mode", "midpoint"))
        q_max = float(cfg.get("q_max", 0) or
                      (qs[-1] + qs[0] if ft_mode == "midpoint" else qs[-1]))
        fr = opt.get("find_rotation", {})
        rl = fr.get("r_limit_ids", "all")
        r_ids = None if (isinstance(rl, str) and rl == "all") \
            else np.asarray(rl, dtype=int)
        mesh = self._make_mesh(len(densities))
        if dim == 3:
            from xframe_tpu.projects.fxs.reconstruct import \
                load_cached_weights
            ft = SphericalFourierTransform(
                len(rs), L, q_max=q_max, mode=ft_mode,
                reciprocity_coefficient=rc,
                weights_dict=load_cached_weights(L, len(rs), rc, 3, ft_mode),
                n_theta=len(thetas), n_phi=len(phis))
            integ = SphericalIntegrator(rs, len(thetas), len(phis))
            lma = fr.get("l_max_align", "auto")
            aligner = Aligner(ft, integ._w, r_limit_ids=r_ids,
                              bandwidth=int(fr.get("so3_n_beta") or 0) or None,
                              l_max_align=None if (isinstance(lma, str))
                              else int(lma), mesh=mesh)
            theta_weights = ft.sht.gl_weights
        else:
            from xframe_tpu.ops.fourier import PolarFourierTransform
            from xframe_tpu.ops.integrate import PolarIntegrator
            from xframe_tpu.projects.fxs.alignment import Aligner2D
            ft = PolarFourierTransform(len(rs), L, len(phis), q_max,
                                       mode=ft_mode,
                                       reciprocity_coefficient=rc)
            integ = PolarIntegrator(rs, len(phis))
            aligner = Aligner2D(ft, integ._w, r_limit_ids=r_ids, mesh=mesh)
            theta_weights = None

        have_psi = psis is not None
        rho_stack = jnp.asarray(
            np.stack(densities).astype(np.complex64))
        psi_stack = jnp.asarray(
            np.stack(psis).astype(np.complex64)) if have_psi else None

        # center (one vmapped call; companions phase-shifted identically)
        if bool(opt.get("center_reconstructions", True)):
            rho_stack, psi_stack, coms = aligner.center_batch(rho_stack,
                                                              psi_stack)
            if bool(opt.get("use_masks", False)) and masks is not None:
                # shift each support mask by its density's centering shift
                # (via the same reciprocal phase ramp) and zero the density
                # where the shifted mask falls below the threshold —
                # suppresses the phase-ramp wrap-around (reference
                # average.py:154-160)
                thr = float(opt.get("shifted_mask_threshold", 0.5))
                m = jnp.asarray(
                    np.stack(masks).astype(np.complex64))
                m_psi = jax.jit(jax.vmap(ft.forward))(m)
                m_psi = aligner._batch_psi_shift(m_psi, coms)
                m_shift = jax.jit(jax.vmap(ft.inverse))(m_psi).real
                rho_stack = jax.jit(
                    lambda r, ms: jnp.where(ms >= thr, r, 0))(
                    rho_stack, m_shift)

        # normalize: reference scales ρ AND its companion by the same factor
        # and keeps the factors for projection-matrix averaging
        # (reference average.py:165-186). Device-side: the stacks never
        # round-trip to the host just to be scaled (2× ~270 MB of transfer
        # at tutorial scale; the whole averaging chain below stays
        # device-resident, and only the artifacts the result file stores
        # come back).
        mode = str(opt.get("normalize_reconstructions", {}).get("mode", "max"))
        use_norm = bool(opt.get("normalize_reconstructions", {}).get("use", True))
        scaling_factors = np.ones(len(densities))
        if use_norm:
            red = tuple(range(1, rho_stack.ndim))

            def _scales(r):
                m = jnp.abs(r)
                s = m.max(axis=red) if mode == "max" \
                    else jnp.maximum(m.mean(axis=red), 1e-30)
                return jnp.maximum(s, 1e-30)

            scales = jax.jit(_scales)(rho_stack)
            div = jax.jit(
                lambda a, s: a / s.reshape((-1,) + (1,) * (a.ndim - 1)))
            rho_stack = div(rho_stack, scales)
            if have_psi:
                psi_stack = div(psi_stack, scales)
            scaling_factors = np.asarray(np.asarray(scales), dtype=float)

        # reference = lowest error (list already error-sorted); optionally
        # point-inverted so every alignment (and so the average) lands on the
        # opposite handedness (reference average.py:198-204)
        if bool(opt.get("pointinvert_reference", False)):
            ref_d = jax.jit(lambda r: ft.inverse(ft.forward(r).conj()))(
                rho_stack[0])
            rho_stack = jax.jit(lambda st, r: st.at[0].set(r))(rho_stack,
                                                               ref_d)
            if have_psi:
                psi_stack = jax.jit(
                    lambda st: st.at[0].set(st[0].conj()))(psi_stack)
        else:
            ref_d = rho_stack[0]
        ref = np.asarray(np.asarray(ref_d))
        ref_coeff = aligner.coefficients(ref_d)

        lim = opt.get("alignment_error_limit", None)
        l2_limit = float(lim) if not isinstance(lim, (bool, type(None))) \
            else float(opt.get("l2_error_limit", 0.5))
        check_inv = bool(opt.get("find_rotation", {})
                         .get("check_point_inversion", True))
        max_iter = max(int(opt.get("max_iterations", 1)), 1)
        aligned = [ref]
        align_info = [{"angles": (0.0, 0.0, 0.0), "score": np.inf,
                       "inverted": False, "l2_to_ref": 0.0}]
        used_meta = [meta[0]]
        n_cand = int(rho_stack.shape[0]) - 1
        sel_idx = []                    # candidate rows that pass l2_limit
        rho_rot = psi_rot = None
        if n_cand > 0:
            cand = rho_stack[1:]
            cand_psi = psi_stack[1:] if have_psi else None
            rho_rot, psi_rot, l2s, infos = aligner.align_batch(
                cand, ref_coeff, ref_rho=ref_d, psis=cand_psi,
                check_point_inversion=check_inv)
            # iterative refinement (reference alignment_loop max_iterations,
            # average.py:1046-1085): re-align the rotated candidates — the
            # composed rotation lands between the discrete SO(3) grid points
            # of a single pass; keep a candidate's refinement only if its
            # l2-to-reference improved.
            for _ in range(max_iter - 1):
                l2s_h = np.asarray(np.asarray(l2s))
                if (l2s_h <= l2_limit).all():
                    break
                rho2, psi2, l2s2, _ = aligner.align_batch(
                    rho_rot, ref_coeff, ref_rho=ref_d, psis=psi_rot,
                    check_point_inversion=False)
                better = jnp.asarray(np.asarray(np.asarray(l2s2))
                                     < l2s_h)
                pick = jax.jit(lambda a, b, m: jnp.where(
                    m.reshape((-1,) + (1,) * (a.ndim - 1)), a, b))
                rho_rot = pick(rho2, rho_rot, better)
                if psi_rot is not None:
                    psi_rot = pick(psi2, psi_rot, better)
                l2s = jnp.where(better, jnp.asarray(l2s2), jnp.asarray(l2s))
                for i, b in enumerate(np.asarray(np.asarray(better))):
                    infos[i]["refined"] = bool(b) or infos[i].get("refined",
                                                                  False)
            # the aligned densities are part of the result file — this
            # readback is the product; per-candidate ψ companions are NOT
            # stored, so only their device-side means come back (below)
            rho_rot_h = np.asarray(rho_rot)
            l2s_np = np.asarray(np.asarray(l2s))
            for i, info in enumerate(infos):
                info["l2_to_ref"] = float(l2s_np[i])
                if l2s_np[i] > l2_limit:
                    continue
                sel_idx.append(i)
                aligned.append(rho_rot_h[i])
                align_info.append(info)
                used_meta.append(meta[i + 1])

        # device-resident aligned stack: reference + the selected rotated
        # candidates (selection indices are host-static)
        def _head_plus_selected(head, rows):
            if sel_idx:
                take = jnp.asarray(np.asarray(sel_idx))
                return jax.jit(lambda h, r: jnp.concatenate(
                    [h[None], r[take]]))(head, rows)
            return jax.jit(lambda h: h[None])(head)

        aligned_d = _head_plus_selected(ref_d, rho_rot)
        avg_d = jax.jit(lambda a: a.mean(axis=0))(aligned_d)
        avg = np.asarray(np.asarray(avg_d))
        centered_avg = np.asarray(aligner.center(avg_d)[0])
        psi_avg = np.asarray(aligner._ft_fwd(avg_d))      # FT of the average

        # reciprocal amplitudes of every aligned density — one vmapped call
        # on the device-resident stack (host PRTF/FSC consume them)
        psis_from_rho = np.stack(np.asarray(
            jax.jit(jax.vmap(ft.forward))(aligned_d)))
        # intensity averages (reference average.py:241-242)
        intensity_from_density = np.mean(np.abs(psis_from_rho) ** 2, axis=0)
        if have_psi:
            psi_aligned_d = _head_plus_selected(psi_stack[0], psi_rot)
            avg_ft_density = np.asarray(np.asarray(
                jax.jit(lambda p: p.mean(axis=0))(psi_aligned_d)))
            intensity_from_ft_density = np.asarray(np.asarray(
                jax.jit(lambda p: (jnp.abs(p) ** 2).mean(axis=0))(
                    psi_aligned_d)))

        metrics = {}
        axes = None if dim == 3 else (-1,)
        prtf_axes = None if dim == 3 else (1,)
        if bool(opt.get("resolution_metrics", {}).get("PRTF", True)):
            prtf_vals = rm.prtf(psis_from_rho, theta_weights=theta_weights,
                                axes=axes)
            q_res, d_res = rm.prtf_resolution(prtf_vals, qs)
            metrics["PRTF"] = prtf_vals
            metrics["PRTF_qs"] = qs
            metrics["PRTF_resolution_q"] = q_res
            # data-relative variants (reference average.py:250-263 →
            # resolution_metrics.PRTF_fxs :90-101)
            p, s = rm.prtf_fxs(psi_avg, intensity_from_density,
                               axes=prtf_axes)
            metrics["PRTF_from_density"] = p
            metrics["PRTF_from_density_std"] = s
            if have_psi:
                p, s = rm.prtf_fxs(psi_avg, intensity_from_density,
                                   avg_ft_density, intensity_from_ft_density,
                                   axes=prtf_axes)
                metrics["PRTF_fxs"] = p
                metrics["PRTF_fxs_std"] = s
                p, s = rm.prtf_fxs(avg_ft_density, intensity_from_ft_density,
                                   axes=prtf_axes)
                metrics["PRTF_from_ft_density"] = p
                metrics["PRTF_from_ft_density_std"] = s
                p, s = rm.prtf_fxs(psi_avg, intensity_from_ft_density,
                                   axes=prtf_axes)
                metrics["PRTF_ftI"] = p
                metrics["PRTF_ftI_std"] = s
                # pseudo-FSC between the average's FT and the averaged
                # projected amplitude (reference average.py:304)
                metrics["pseudo_FSC"] = np.abs(rm.fsc(
                    psi_avg, avg_ft_density, theta_weights, axes=axes))
        if bool(opt.get("resolution_metrics", {}).get("FSC", False)) \
                and len(aligned) >= 2:
            half = len(aligned) // 2
            psi_a = np.mean(psis_from_rho[:half], axis=0)
            psi_b = np.mean(psis_from_rho[half:], axis=0)
            metrics["FSC"] = np.abs(rm.fsc(psi_a, psi_b, theta_weights,
                                           axes=axes))
            n_shell = max(len(thetas), 1) * len(phis) * np.ones(len(qs))
            metrics["FSC_half_bit"] = rm.half_bit_threshold(n_shell)

        # projection matrices averaged over input files, rescaled by each
        # file's mean density normalization (reference
        # average.py:90-100,183-186 get_averaged_projection_matrices)
        proj_matrices = self._averaged_projection_matrices(
            proj_per_file, used_meta, scaling_factors, meta)
        if bool(opt.get("resolution_metrics", {}).get("FQCB", False)) \
                and proj_matrices is not None:
            # invariant-space fidelity: B from the averaged density vs the
            # data's B = V V† (reference average.py:266-295 FQCB block)
            from xframe_tpu.projects.fxs import invariants as itools
            intensity = np.abs(psi_avg) ** 2
            if dim == 3:
                coeff = np.asarray(jax.jit(ft.sht.forward)(
                    jnp.asarray(intensity.astype(complex))))
                b_rec = itools.harmonic_coeff_to_deg2_invariants_3d(coeff)
                b_target = itools.projection_matrices_to_deg2_invariant_3d(
                    proj_matrices)
            else:
                cm = np.fft.fft(intensity, axis=-1)[:, : L + 1] / len(phis)
                b_rec = itools.harmonic_coeff_to_deg2_invariants_2d(cm)
                vecs = [np.atleast_2d(np.asarray(v)).reshape(len(qs), -1)
                        for v in proj_matrices]
                b_target = np.stack([v @ v.conj().T for v in vecs])
            f_q, f_std, f_2d = rm.fqcb(b_rec, b_target, skip_odd_orders=True)
            metrics["FQCB_from_density"] = f_q
            metrics["FQCB_from_density_std"] = f_std
            f_qz, f_stdz, _ = rm.fqcb(b_rec, b_target, skip_odd_orders=True,
                                      include_zero_order=True)
            metrics["FQCB_from_density_with_zero_order"] = f_qz
            metrics["FQCB_from_density_with_zero_order_std"] = f_stdz

        # normalized density: (d − d_min)/(d_max − d_min) with an optional
        # fixed floor (reference normalize_density + average_normalization_min,
        # average.py:546,721-727)
        d_min = opt.get("average_normalization_min", False)
        d_min = float(np.real(avg).min()) if isinstance(d_min, bool) \
            else float(d_min)
        d_max = float(np.real(avg).max())
        norm_avg = (avg - d_min) / max(d_max - d_min, 1e-30)
        avg_group = {
            "real_density": avg,
            "normalized_real_density": norm_avg,
            # reference semantics: the average's reciprocal density is the
            # mean of the aligned PROJECTED amplitudes when available
            # (average.py:239,316), else the FT of the averaged density
            "reciprocal_density": (avg_ft_density if have_psi else psi_avg),
            "intensity_from_densities": intensity_from_density,
        }
        if have_psi:
            avg_group["intensity_from_ft_densities"] = intensity_from_ft_density
        return {
            "average": avg_group,
            "centered_average": centered_avg,
            "aligned": {str(i): a for i, a in enumerate(aligned)},
            "input": {str(i): d for i, d in enumerate(densities)},
            "input_meta": {str(i): m for i, m in enumerate(used_meta)},
            "scaling_factors": scaling_factors,
            "resolution_metrics": metrics,
            "rotation_metric": {
                "angles": np.asarray([list(i["angles"]) for i in align_info]),
                "scores": np.asarray([i["score"] for i in align_info]),
                "inverted": np.asarray([i["inverted"] for i in align_info]),
                "l2_to_ref": np.asarray([i["l2_to_ref"] for i in align_info]),
            },
            "so3_grid": ({"alphas": aligner.corr.alphas,
                          "betas": aligner.corr.betas,
                          "gammas": aligner.corr.gammas} if dim == 3
                         else {"alphas": aligner.alphas}),
            "grid": {"rs": rs, "thetas": thetas, "phis": phis, "qs": qs},
        }

    def _make_mesh(self, n_candidates):
        """Candidate-alignment device mesh (mesh.restarts, same knob as the
        reconstruct worker): default shards candidates over all devices."""
        from xframe_tpu.parallel.mesh import make_mesh
        opt = self.settings.get("mesh", {})
        devices = jax.devices()
        if len(devices) <= 1 or n_candidates <= 1:
            return None
        r = opt.get("restarts", "all")
        n_r = len(devices) if (isinstance(r, str) and r == "all") else int(r)
        # clamp to the work-item count (as reconstruct clamps to
        # n_restarts): a mesh wider than the candidate list would wrap-pad
        # and re-align duplicate candidates only to trim them afterwards
        n_r = max(1, min(n_r, n_candidates, len(devices)))
        if n_r <= 1:
            return None
        return make_mesh({"restarts": n_r})

    @staticmethod
    def _averaged_projection_matrices(proj_per_file, used_meta,
                                      scaling_factors, all_meta):
        """V̄_l = mean_files V_l^{(f)} / s_f², s_f the mean normalization
        scale over ALL of file f's selected reconstructions — including ones
        the later l2 alignment filter drops, as in the reference, whose
        average_scaling_factors_per_file is computed at load time
        (average.py:90-100,183-186); only files that contributed at least
        one used candidate enter the mean."""
        if not proj_per_file or proj_per_file[0] is None:
            return None
        used_files = sorted({m["file_index"] for m in used_meta})
        usable = [f for f in used_files if proj_per_file[f] is not None]
        if not usable:
            return None
        # per-file mean scale over the candidates that entered the average
        file_scale = {}
        for f in usable:
            ids = [i for i, m in enumerate(all_meta) if m["file_index"] == f]
            file_scale[f] = float(np.mean(scaling_factors[ids])) if ids else 1.0

        def as_list(pm):
            if isinstance(pm, dict):
                return [np.asarray(pm[k]) for k in
                        sorted(pm, key=lambda x: int(x))]
            return [np.asarray(v) for v in pm]

        stacks = {f: as_list(proj_per_file[f]) for f in usable}
        n_l = min(len(s) for s in stacks.values())
        out = []
        for l in range(n_l):
            acc = None
            for f in usable:
                v = stacks[f][l] / file_scale[f] ** 2
                acc = v if acc is None else acc + v
            out.append(acc / len(usable))
        return out
