"""correlate worker: detector frames → angular cross-correlation C(q1,q2,Δ).

Pipeline (reference projects/fxs/correlate.py + projectLibrary/
cross_correlation.py:17-78, SURVEY.md §3.2): read raw frames (host IO) →
mask/threshold → cartesian→polar interpolation → corrections → per-frame
FFT cross-correlation with mask-CCF normalization → accumulate → ccd.h5.

Design: the reference forked one process per CPU core and correlated
frame-by-frame; here frames stream through ONE jitted batch program
(map_coordinates regrid + rfft + batched outer product as one einsum), with
host-side accumulation across batches.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from xframe_tpu.interfaces import ProjectWorkerInterface
from xframe_tpu.library.physics import scattering_angle_to_reciprocal_radii
from xframe_tpu.projects.fxs._database_ import ProjectDB
from xframe_tpu.settings import loader as settings_loader


def _low_pass_cc(cc, fc_n_max):
    """Zero CC harmonics above fc_n_max (the reference keeps FCs only up to
    this order, settings fc_n_max)."""
    if not fc_n_max or fc_n_max >= cc.shape[-1] // 2:
        return cc
    f = np.fft.rfft(cc, axis=-1)
    f[..., int(fc_n_max) + 1:] = 0
    return np.fft.irfft(f, cc.shape[-1], axis=-1)


def symmetrize_cc(cc, phis):
    """Flat-Ewald CC symmetrization (reference cross_correlation.py:67-78):
    the noisy Δ∈[0,π/2) and Δ∈(3π/2,2π] ranges are replaced by the values
    shifted by π from the clean interior."""
    phis = np.asarray(phis)
    pos_pi2 = int(np.abs(phis - np.pi / 2).argmin())
    pos_pi = int(np.abs(phis - np.pi).argmin())
    pos_3pi2 = int(np.abs(phis - 3 * np.pi / 2).argmin())
    n = cc.shape[-1]
    out = np.array(cc, copy=True)
    out[..., :pos_pi2] = cc[..., pos_pi:pos_pi + pos_pi2]
    out[..., pos_3pi2 + 1:] = cc[..., pos_3pi2 + 1 - pos_pi:n - pos_pi]
    return out


def refine_detector_origin(mean_frame, origin0, search_radius_pix=3.0,
                           steps=7, n_bins=64):
    """Grid-search the beam center that maximizes azimuthal symmetry of the
    averaged pattern: minimizes Σ_rings var(I)/mean(I)² (the reference keeps
    this only in the SPB expLibrary; here it serves the single-panel path
    too). Degenerate candidates (empty frame, origin at the edge) score +inf
    — an all-degenerate search returns origin0. → refined (oy, ox) pixels."""
    from xframe_tpu.library.mathtools import ring_symmetry_score
    frame = np.asarray(mean_frame, dtype=np.float64)
    ny, nx = frame.shape
    yy, xx = np.mgrid[0:ny, 0:nx]
    offsets = np.linspace(-search_radius_pix, search_radius_pix, int(steps))
    weights = frame.ravel()
    best = (np.inf, tuple(float(v) for v in origin0))
    for dy in offsets:
        for dx in offsets:
            oy, ox = origin0[0] + dy, origin0[1] + dx
            r = np.hypot(yy - oy, xx - ox)
            r_max = min(oy, ox, ny - 1 - oy, nx - 1 - ox)
            score = ring_symmetry_score(r, weights, n_bins, r_max=r_max)
            if score < best[0]:
                best = (score, (float(oy), float(ox)))
    return best[1]


def _split_batch_item(item):
    """(batch, good) from a frame-stream item: plain batches get an all-good
    mask; (batch, mask) pairs (native loader read-ok flags, experiment
    good-frame bookkeeping) pass their mask through."""
    if isinstance(item, tuple):
        batch, good = item
        return (np.asarray(batch, dtype=np.float32),
                np.asarray(good, dtype=np.float32))
    batch = np.asarray(item, dtype=np.float32)
    return batch, np.ones(len(batch), dtype=np.float32)


class Correlator:
    """Device-side batch correlator closed over the detector geometry.

    Frame-option parity with the reference DataReader
    (reference correlate.py:107-452):
    qrange/qrange_xcca (:489-559), radial pixel filter (:401-413),
    ROI normalization + ROI-mean frame rejection (:424-432), φ-range
    (:496-525), CC symmetrization (:261-266)."""

    def __init__(self, image_shape, detector_origin, pixel_size_um,
                 sample_distance_mm, wavelength, n_phi=1024, n_q=None,
                 interpolation_order=1, mask_below=None, mask_above=None,
                 polarization=False, solid_angle=False, background=None,
                 fc_n_max=None, with_ccf=True, qrange=None, qrange_xcca=None,
                 phi_range=None, phi_sampling_mode=None, roi_q_range=None,
                 roi_normalize=False, roi_mean_bounds=None,
                 radial_pixel_filter=None, symmetrize=False,
                 static_mask=None):
        """background: per-pixel frame subtracted before filtering
        (filters.background_file); fc_n_max: low-pass the final CC to this
        harmonic order; with_ccf=False skips the CC accumulation entirely
        (settings `compute` without 'ccf': WAXS/is_good-only runs).

        qrange=(q_min, q_max, q_step) [Å⁻¹] defines the radial grid in
        momentum-transfer space (reference :489-502); default derives a
        uniform pixel-radius grid from the detector half-size.
        qrange_xcca=((q1_min,q1_max,idx_step),(q2_min,q2_max,idx_step))
        restricts the CCF to radial index subsets (reference :546-559).
        phi_range=(φ_min, φ_max) azimuthal window; phi_sampling_mode
        'max'|'min' caps/floors n_phi at the feasible 1-pixel circumference
        sampling at q_max (reference :505-522).
        roi_q_range=(q_lo, q_hi): rows used for ROI statistics;
        roi_normalize divides each frame by its masked ROI mean,
        roi_mean_bounds=(lo, hi) rejects frames outside (reference :424-432).
        radial_pixel_filter=('average_sigma'|'median_mad', n_sigma): masks
        polar pixels deviating > n_sigma spreads from their ring statistic
        (reference :401-413). symmetrize: replace Δ∈[0,π/2) and (3π/2,2π]
        by the shifted interior values at save time (reference
        cross_correlation.py:67-78)."""
        ny, nx = image_shape
        oy, ox = float(detector_origin[0]), float(detector_origin[1])
        r_max_pix = min(oy, ox, ny - 1 - oy, nx - 1 - ox)
        dist_pix = sample_distance_mm * 1000.0 / pixel_size_um
        self.wavelength = wavelength

        if qrange is not None:
            # q-space grid: q rings map to pixel radii via r = tan(2θ)·D
            q_min, q_max, q_step = [float(v) for v in qrange]
            self.n_q = int((q_max - q_min) / q_step + 1)
            self.qs = np.arange(self.n_q) * q_step + q_min
            angles = 2.0 * np.arcsin(self.qs * wavelength / (4 * np.pi))
            r_pix = np.tan(angles) * dist_pix
        else:
            if n_q is None or n_q <= 0:
                n_q = int(r_max_pix)
            self.n_q = int(n_q)
            r_pix = (np.arange(self.n_q) + 0.5) * r_max_pix / self.n_q
            angles = np.arctan(r_pix / dist_pix)
            self.qs = scattering_angle_to_reciprocal_radii(angles, wavelength)
        self.order = int(interpolation_order)

        # azimuthal window + feasible-sampling cap (reference :505-522)
        phi_min, phi_max = (0.0, 2 * np.pi) if phi_range is None \
            else (float(phi_range[0]), float(phi_range[1]))
        n_phi = int(n_phi)
        if phi_sampling_mode in ("max", "min"):
            maxpix = int(round(2 * np.pi * float(r_pix[-1])))
            maxpix += maxpix % 2
            n_phi = min(maxpix, n_phi) if phi_sampling_mode == "max" \
                else max(maxpix, n_phi)
        self.n_phi = n_phi
        phis = phi_min + (phi_max - phi_min) * np.arange(n_phi) / n_phi
        self.phis = phis

        # polar sample coordinates in pixel units (host constants)
        yy = oy + r_pix[:, None] * np.sin(phis)[None, :]
        xx = ox + r_pix[:, None] * np.cos(phis)[None, :]
        self._coords = np.stack([yy, xx]).astype(np.float32)  # (2, n_q, n_phi)

        corr = np.ones((self.n_q, self.n_phi))
        if solid_angle:
            # 1/cos³(2θ) flat-detector solid-angle correction
            corr *= 1.0 / np.cos(angles)[:, None] ** 3
        if polarization:
            # linear polarization factor 1/(cos²2θ + sin²2θ·trig²φ):
            # trig = sin for vertical, cos for horizontal polarization
            # (reference :565-582)
            trig = np.cos if str(polarization) == "h" else np.sin
            corr /= np.maximum(
                np.cos(angles)[:, None] ** 2
                + (np.sin(angles)[:, None] * trig(phis)[None, :]) ** 2, 1e-3)
        self._corrections = corr.astype(np.float32)
        self.mask_below = mask_below
        self.mask_above = mask_above
        self._background = None if background is None else \
            np.asarray(background, dtype=np.float32)
        # per-pixel binary mask applied to every frame (reference
        # use_binary_mask + binary_mask file, correlate.py:157-164)
        self._static_mask = None if static_mask is None else \
            np.asarray(static_mask) > 0.5
        self.fc_n_max = None if not fc_n_max else int(fc_n_max)
        self.with_ccf = bool(with_ccf)
        self.symmetrize = bool(symmetrize)

        # CCF radial index subsets (reference :546-559)
        if qrange_xcca is not None:
            (a_lo, a_hi, a_st), (b_lo, b_hi, b_st) = qrange_xcca
            p1 = int(np.abs(self.qs - float(a_lo)).argmin())
            p2 = int(np.abs(self.qs - float(a_hi)).argmin())
            self.q1_pos = np.arange(p1, p2 + 1, int(a_st))
            p1 = int(np.abs(self.qs - float(b_lo)).argmin())
            p2 = int(np.abs(self.qs - float(b_hi)).argmin())
            self.q2_pos = np.arange(p1, p2 + 1, int(b_st))
        else:
            self.q1_pos = self.q2_pos = np.arange(self.n_q)

        # ROI rows for normalization / frame rejection (reference :186-192)
        self._roi = None
        if roi_q_range is not None:
            lo = int(np.abs(self.qs - float(roi_q_range[0])).argmin())
            hi = int(np.abs(self.qs - float(roi_q_range[1])).argmin())
            self._roi = (lo, max(hi, lo + 1))
        self.roi_normalize = bool(roi_normalize)
        self.roi_mean_bounds = None if roi_mean_bounds is None else \
            (float(roi_mean_bounds[0]), float(roi_mean_bounds[1]))
        self.radial_pixel_filter = None if radial_pixel_filter is None else \
            (str(radial_pixel_filter[0]), float(radial_pixel_filter[1]))

        self._process = jax.jit(self._process_batch)

    # -------------------------------------------------------------- device fn
    def _regrid(self, frame):
        return jax.scipy.ndimage.map_coordinates(frame, list(self._coords),
                                                 order=self.order, cval=0.0)

    def _process_batch(self, frames, good):
        """frames (B, ny, nx) f32; good (B,) f32 0/1 →
        accumulated (cc_f, cc_m, waxs_sum, count_sum, n_good).

        Per-frame step order matches the reference process_image
        (correlate.py:377-452): threshold masks on RAW values → background
        subtraction → polar regrid → radial pixel filter → ROI mean
        filter/normalization → polarization/solid-angle corrections."""
        valid = jnp.isfinite(frames)
        if self._static_mask is not None:
            valid &= jnp.asarray(self._static_mask)[None]
        if self.mask_below is not None:
            valid &= frames > self.mask_below
        if self.mask_above is not None:
            valid &= frames < self.mask_above
        if self._background is not None:
            frames = frames - self._background
        frames = jnp.where(valid, frames, 0.0)

        polar = jax.vmap(self._regrid)(frames)                  # (B, n_q, n_phi)
        pmask = jax.vmap(self._regrid)(valid.astype(jnp.float32)) > 0.99
        polar = polar * pmask

        if self.radial_pixel_filter is not None:
            mode, n_sig = self.radial_pixel_filter
            mf = pmask.astype(polar.dtype)
            if mode == "median_mad":
                nan_polar = jnp.where(pmask, polar, jnp.nan)
                center = jnp.nanmedian(nan_polar, axis=-1, keepdims=True)
                spread = jnp.nanmedian(jnp.where(pmask,
                                                 jnp.abs(polar - center),
                                                 jnp.nan),
                                       axis=-1, keepdims=True)
            else:  # 'average_sigma'
                cnt = jnp.maximum(mf.sum(axis=-1, keepdims=True), 1.0)
                center = (polar * mf).sum(axis=-1, keepdims=True) / cnt
                var = (((polar - center) * mf) ** 2).sum(
                    axis=-1, keepdims=True) / cnt
                spread = jnp.sqrt(var)
            keep = jnp.abs(polar - center) <= n_sig * spread
            pmask &= jnp.where(jnp.isnan(center) | jnp.isnan(spread),
                               True, keep)
            polar = polar * pmask

        # completely-masked frames are bad (reference :418-421)
        good = good * (pmask.sum(axis=(1, 2)) > 0)

        if self._roi is not None:
            lo, hi = self._roi
            rm = pmask[:, lo:hi, :].astype(polar.dtype)
            roi_cnt = rm.sum(axis=(1, 2))
            roi_mean = (polar[:, lo:hi, :] * rm).sum(axis=(1, 2)) \
                / jnp.maximum(roi_cnt, 1.0)
            if self.roi_mean_bounds is not None:
                lo_v, hi_v = self.roi_mean_bounds
                good = good * ((roi_mean >= lo_v) & (roi_mean <= hi_v))
            if self.roi_normalize:
                # divide by the ACTUAL (possibly negative, after background
                # subtraction) ROI mean as the reference does
                # (correlate.py:432 np.divide); frames whose ROI is fully
                # masked or has an exactly-zero mean cannot be normalized
                # and are flagged bad instead of being scaled by a clamp
                ok = (roi_cnt > 0) & (roi_mean != 0)
                good = good * ok
                polar = polar / jnp.where(ok, roi_mean, 1.0)[:, None, None]

        polar = polar * self._corrections * pmask

        g = good[:, None, None]
        if self.with_ccf:
            f = jnp.fft.rfft(polar * g, axis=-1)                # (B, n_q, n+1)
            m = jnp.fft.rfft(pmask.astype(jnp.float32) * g, axis=-1)
            # Σ_frames Î(q1)* Î(q2): batched outer product over the (possibly
            # qrange_xcca-restricted) radial subsets — one einsum
            f1, f2 = f[:, self.q1_pos], f[:, self.q2_pos]
            m1, m2 = m[:, self.q1_pos], m[:, self.q2_pos]
            cc_f = jnp.einsum("bqn,bpn->qpn", f1.conj(), f2,
                              precision="highest")
            cc_m = jnp.einsum("bqn,bpn->qpn", m1.conj(), m2,
                              precision="highest")
        else:
            cc_f = cc_m = jnp.zeros((), dtype=jnp.complex64)
        waxs = jnp.sum(polar * g, axis=0)
        count = jnp.sum(pmask * g[..., 0][:, :, None], axis=0)
        return cc_f, cc_m, waxs, count, jnp.sum(good)

    # ---------------------------------------------------------------- streaming
    def correlate_frames(self, frame_iter, batch_size=64, is_good=None):
        """Accumulate the mask-corrected CC over a stream of frames.

        frame_iter yields (B, ny, nx) float32 numpy batches, or
        (batch, good_mask) pairs (e.g. the native PrefetchingFrameLoader
        flagging unreadable files); is_good filters compose on top."""
        acc = None
        for item in frame_iter:
            batch, good = _split_batch_item(item)
            if is_good is not None:
                good = good * np.asarray(is_good(batch), dtype=np.float32)
            out = self._process(batch, good)
            out = [o for o in out]
            if acc is None:
                acc = out
            else:
                acc = [jax.jit(jnp.add)(a, o) for a, o in zip(acc, out)]
        cc_f, cc_m, waxs, count, n_good = [np.asarray(a) for a in acc]
        cc = None
        if self.with_ccf:
            # mask-CCF normalization (cross_correlation.py:56-62): per-Δ counts
            ccf = np.fft.irfft(cc_f, self.n_phi, axis=-1)
            ccm = np.fft.irfft(cc_m, self.n_phi, axis=-1)
            cc = np.where(ccm > 0.5, ccf / np.where(ccm > 0.5, ccm, 1.0), 0.0)
            if self.symmetrize:
                cc = symmetrize_cc(cc, self.phis)
            cc = _low_pass_cc(cc, self.fc_n_max)
        avg_intensity = np.where(count > 0, waxs / np.maximum(count, 1), 0.0)
        return {
            "cross_correlation": cc,
            "average_intensity": avg_intensity.mean(axis=-1),
            "num_images_good": int(n_good),
        }


class ProjectWorker(ProjectWorkerInterface):
    database_class = ProjectDB

    def run(self):
        if str(self.settings.get("input", {}).get("source", "files")) \
                == "experiment":
            return self._run_experiment()
        return self._run_files()

    # --------------------------------------------- facility (multi-panel) path
    def _run_experiment(self):
        """Stream calibrated AGIPD frames from an SPB run folder through the
        geometry-binned PanelCorrelator (reference correlate-on-experiment
        path via comm_module.get_data)."""
        opt = self.settings
        eopt = opt.get("experiment", {})
        from xframe_tpu.experiments.SPB.experiment import (
            ExperimentWorker, DataSelection, Filters)
        exp = ExperimentWorker(
            str(eopt["run_folder"]),
            geometry_file=eopt.get("geometry_file") or None,
            detector_distance=float(eopt.get("detector_distance", 0.217)),
            wavelength=float(opt.wavelength),
            filters=Filters(lit_pixel_fraction_min=float(
                opt.get("filters", {}).get("lit_pixel_fraction_min", 0) or 0)))
        mods = tuple(sorted(exp._module_files))  # modules present in the run
        corr = PanelCorrelator(
            exp.get_pixel_grid_reciprocal()[list(mods)],
            n_q=int(opt.polar_grid.get("n_q", 0) or 128),
            n_phi=int(opt.polar_grid.n_phi),
            fc_n_max=int(opt.get("fc_n_max", 0) or 0) or None)
        n_max = opt.get("max_n_patterns", "all")
        stop = None if (isinstance(n_max, str) and n_max == "all") else int(n_max)
        sel = DataSelection(frame_range=(0, stop), modules=mods,
                            batch_size=int(opt.get("batch_size", 32)))

        def frames():
            for chunk in exp.get_data(sel):
                yield chunk["data"], chunk["good"]

        out = corr.correlate_frames(frames())
        data = {
            "dimensions": 3,
            "radial_points": corr.qs,
            "angular_points": corr.phis,
            "xray_wavelength": float(opt.wavelength),
            "average_intensity": out["average_intensity"],
            "cross_correlation": {"I1I1": out["cross_correlation"]},
            "num_images_processed": exp.n_frames() if stop is None else stop,
            "num_images_good": out["num_images_good"],
        }
        path, run = self.db.save("ccd", data)
        print(f"correlate(experiment): saved to {path}")
        return data

    # ------------------------------------------------- single-panel .raw path
    def _run_files(self):
        opt = self.settings
        ny, nx = [int(v) for v in opt.image_dimensions]
        fopt = opt.get("filters", {})
        compute = [str(c) for c in opt.get("compute",
                                           ["is_good", "waxs_aver",
                                            "ccf_q1q2"])]
        with_ccf = any(c.startswith("ccf") for c in compute)
        background = self._load_background(fopt.get("background_file"),
                                           (ny, nx))
        static_mask = self._load_background(fopt.get("mask_file"), (ny, nx))
        paths = self._frame_paths()
        n_max = opt.get("max_n_patterns", "all")
        if not (isinstance(n_max, str) and n_max == "all"):
            paths = paths[: int(n_max)]
        dtype = np.dtype(str(opt.get("input", {}).get("dtype", "float32")))
        batch_size = int(opt.get("batch_size", 64))

        origin = [float(v) for v in opt.detector_origin]
        refine = opt.get("refine_beam_center", False)
        if refine:
            origin = self._refine_origin(paths, (ny, nx), dtype, origin,
                                         refine, batch_size)

        def _pair(v):
            return None if (v is None or v is False) else \
                tuple(float(x) for x in v)

        roi = fopt.get("roi", {}) or {}
        rpf = fopt.get("radial_pixel_filter", False)
        polarization = opt.get("corrections", {}).get("polarization", False)
        corr = Correlator(
            (ny, nx), origin, float(opt.pixel_size),
            float(opt.sample_distance), float(opt.wavelength),
            n_phi=int(opt.polar_grid.n_phi),
            n_q=int(opt.polar_grid.get("n_q", 0)),
            interpolation_order=int(opt.get("interpolation_order", 1)),
            mask_below=fopt.get("mask_below") if fopt.get("mask_below") is not False else None,
            mask_above=fopt.get("mask_above") if fopt.get("mask_above") is not False else None,
            polarization=polarization,
            solid_angle=bool(opt.get("corrections", {}).get("solid_angle", False)),
            background=background,
            fc_n_max=int(opt.get("fc_n_max", 0) or 0) or None,
            with_ccf=with_ccf,
            qrange=_pair(opt.get("qrange", False)),
            qrange_xcca=None if not opt.get("qrange_xcca", False)
            else tuple(tuple(float(x) for x in row)
                       for row in opt.qrange_xcca),
            phi_range=_pair(opt.get("phi_range", False)),
            phi_sampling_mode=opt.polar_grid.get("phi_sampling_mode") or None,
            roi_q_range=_pair(roi.get("q_range", False)),
            roi_normalize=bool(roi.get("normalize", False)),
            roi_mean_bounds=_pair(roi.get("mean_bounds", False)),
            radial_pixel_filter=None if not rpf
            else (str(rpf[0]), float(rpf[1])),
            symmetrize=bool(opt.get("ccf_2p_symmetrize", False)),
            static_mask=static_mask)
        # C++ thread-pool reader with double-buffered prefetch: the next
        # batch loads while the current one correlates on device
        from xframe_tpu.native import PrefetchingFrameLoader
        frame_iter = PrefetchingFrameLoader(paths, (ny, nx), dtype=dtype,
                                            batch_size=batch_size)

        lit_min = float(fopt.get("lit_pixel_fraction_min", 0.0) or 0.0)

        def is_good(batch):
            if lit_min <= 0:
                return np.ones(len(batch))
            frac = (batch > 0).mean(axis=(1, 2))
            return (frac >= lit_min).astype(np.float32)

        out = corr.correlate_frames(iter(frame_iter), batch_size=batch_size,
                                    is_good=is_good)
        data = {
            "dimensions": 3,
            "radial_points": corr.qs,
            "angular_points": corr.phis,
            "xray_wavelength": corr.wavelength,
            "average_intensity": out["average_intensity"],
            "cross_correlation": {"I1I1": out["cross_correlation"]}
            if out["cross_correlation"] is not None else {},
            "num_images_processed": len(paths),
            "num_images_good": out["num_images_good"],
        }
        if len(corr.q1_pos) != corr.n_q or len(corr.q2_pos) != corr.n_q:
            # qrange_xcca-restricted CCF: radial_points stays the full ring
            # grid (reference format, correlate.py:290) — record the ring
            # subsets so the file is self-describing
            data["qrange_xcca_q1_ids"] = corr.q1_pos
            data["qrange_xcca_q2_ids"] = corr.q2_pos
            data["qrange_xcca_q1_points"] = corr.qs[corr.q1_pos]
            data["qrange_xcca_q2_points"] = corr.qs[corr.q2_pos]
        path, run = self.db.save("ccd", data)
        print(f"correlate: {len(paths)} frames "
              f"({out['num_images_good']} good); saved to {path}")
        return data

    def _refine_origin(self, paths, shape, dtype, origin, refine,
                       batch_size):
        """refine_beam_center: grid-search the detector origin on the mean
        of the first batch before building the polar grid (single-panel
        counterpart of the SPB beam-center refinement)."""
        from xframe_tpu.native import read_frame_batch
        sample = paths[: max(int(batch_size), 8)]
        frames, ok = read_frame_batch(sample, shape, dtype=dtype)
        good = frames[np.asarray(ok, dtype=bool)]
        if not len(good):
            return origin
        mean_frame = np.where(np.isfinite(good), good, 0.0).mean(axis=0)
        ropt = refine if isinstance(refine, dict) else {}
        refined = refine_detector_origin(
            mean_frame, origin,
            search_radius_pix=float(ropt.get("search_radius_pix", 3.0)),
            steps=int(ropt.get("steps", 7)))
        print(f"correlate: beam center refined {tuple(origin)} -> {refined}")
        return list(refined)

    def _load_background(self, spec, shape):
        """filters.background_file: per-pixel background frame (.npy, .h5
        dataset 'background', or raw float32 of the image size)."""
        if not spec:
            return None
        path = str(spec)
        if path.endswith(".npy"):
            bg = np.load(path)
        elif path.endswith((".h5", ".hdf5")):
            from xframe_tpu.io import hdf5 as hdf5_io
            d = hdf5_io.load(path)
            bg = np.asarray(d["background"] if "background" in d
                            else next(iter(d.values())))
        else:
            bg = np.fromfile(path, dtype=np.float32)
        bg = np.asarray(bg, dtype=np.float32).reshape(shape)
        return bg

    def _frame_paths(self):
        inp = self.settings.get("input", {})
        folder = str(inp.get("input_folder", "")) or os.path.join(
            settings_loader.home_dir(), "data", "fxs", "input_files")
        list_path = os.path.join(folder, str(inp.get("file_list",
                                                     "patterns_list.txt")))
        with open(list_path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        return [ln if os.path.isabs(ln) else os.path.join(folder, ln)
                for ln in lines]


class PanelCorrelator:
    """Multi-panel (lab-frame geometry) correlator: detector pixels are
    binned to a polar (q, φ) grid by their Ewald scattering coordinates
    (reference SPB expLibrary regrid path), then the standard mask-corrected
    FFT cross-correlation runs on the binned intensities. Binning is a
    device scatter-add with precomputed flat indices — geometry-agnostic
    (any panel layout a detector class provides)."""

    def __init__(self, pixel_grid_reciprocal, n_q=128, n_phi=512,
                 q_range=None, pixel_mask=None, fc_n_max=None):
        qgrid = np.asarray(pixel_grid_reciprocal)  # (..., 3): (q, θ, φ)
        q = qgrid[..., 0].ravel()
        phi = np.mod(qgrid[..., 2].ravel(), 2 * np.pi)
        if q_range is None:
            q_range = (float(q[q > 0].min()), float(q.max()))
        self.n_q, self.n_phi = int(n_q), int(n_phi)
        self.qs = np.linspace(q_range[0], q_range[1], self.n_q + 1)[:-1] \
            + (q_range[1] - q_range[0]) / (2 * self.n_q)
        self.phis = 2 * np.pi * np.arange(self.n_phi) / self.n_phi

        qi = np.floor((q - q_range[0]) / (q_range[1] - q_range[0])
                      * self.n_q).astype(np.int32)
        pi = np.floor(phi / (2 * np.pi) * self.n_phi).astype(np.int32) \
            % self.n_phi
        valid = (qi >= 0) & (qi < self.n_q)
        if pixel_mask is not None:
            valid &= np.asarray(pixel_mask, dtype=bool).ravel()
        # invalid pixels scatter to a trash bin n_q*n_phi
        flat = np.where(valid, qi * self.n_phi + pi, self.n_q * self.n_phi)
        self._flat_idx = flat.astype(np.int32)
        self._n_bins = self.n_q * self.n_phi + 1
        counts = np.bincount(flat, minlength=self._n_bins)[:-1]
        self._bin_counts = counts.reshape(self.n_q, self.n_phi)

        # CSR-style inverse map: per polar bin, the (padded) pixel-index
        # list. Binning then becomes a dense gather + sum — far better on an
        # accelerator than a scatter/segment_sum (which lowers to sorts). Padding slots
        # point at a zero sentinel appended to each flattened frame.
        order = np.argsort(flat, kind="stable")
        sorted_bins = flat[order]
        starts = np.searchsorted(sorted_bins, np.arange(self._n_bins))
        ends = np.searchsorted(sorted_bins, np.arange(self._n_bins) + 1)
        max_count = int(np.max(ends[:-1] - starts[:-1])) if self.n_q else 1
        n_px = flat.size
        gather = np.full((self.n_q * self.n_phi, max_count), n_px,
                         dtype=np.int32)  # n_px = sentinel slot
        for b in range(self.n_q * self.n_phi):
            lo, hi = starts[b], ends[b]
            gather[b, : hi - lo] = order[lo:hi]
        self._gather_idx = gather
        self._max_count = max_count
        self.fc_n_max = None if not fc_n_max else int(fc_n_max)

        self._process = jax.jit(self._process_batch)

    def _bin_frames(self, frames):
        """(B, ...) → polar sums (B, n_q, n_phi) via padded dense gather."""
        B = frames.shape[0]
        flatframes = frames.reshape(B, -1)
        zero = jnp.zeros((B, 1), dtype=flatframes.dtype)
        padded = jnp.concatenate([flatframes, zero], axis=1)
        gathered = padded[:, self._gather_idx]        # (B, n_bins, max_count)
        return gathered.sum(axis=-1).reshape(B, self.n_q, self.n_phi)

    def _process_batch(self, frames, good):
        polar_sum = self._bin_frames(frames)
        counts = jnp.asarray(np.maximum(self._bin_counts, 1),
                             dtype=jnp.float32)
        polar = polar_sum / counts
        pmask = (jnp.asarray(self._bin_counts) > 0).astype(jnp.float32)
        polar = polar * pmask
        g = good[:, None, None]
        f = jnp.fft.rfft(polar * g, axis=-1)
        m = jnp.fft.rfft(jnp.broadcast_to(pmask, polar.shape) * g, axis=-1)
        cc_f = jnp.einsum("bqn,bpn->qpn", f.conj(), f, precision="highest")
        cc_m = jnp.einsum("bqn,bpn->qpn", m.conj(), m, precision="highest")
        waxs = jnp.sum(polar * g, axis=0)
        count = jnp.sum(jnp.broadcast_to(pmask, polar.shape)
                        * g[..., 0][:, :, None], axis=0)
        return cc_f, cc_m, waxs, count, jnp.sum(good)

    def correlate_frames(self, frame_iter, is_good=None):
        acc = None
        add = jax.jit(jnp.add)
        for item in frame_iter:
            batch, good = _split_batch_item(item)
            if is_good is not None:
                good = good * np.asarray(is_good(batch), dtype=np.float32)
            out = list(self._process(batch, good))
            acc = out if acc is None else [add(a, o)
                                           for a, o in zip(acc, out)]
        cc_f, cc_m, waxs, count, n_good = [np.asarray(a) for a in acc]
        ccf = np.fft.irfft(cc_f, self.n_phi, axis=-1)
        ccm = np.fft.irfft(cc_m, self.n_phi, axis=-1)
        cc = np.where(ccm > 0.5, ccf / np.where(ccm > 0.5, ccm, 1.0), 0.0)
        cc = _low_pass_cc(cc, self.fc_n_max)
        avg = np.where(count > 0, waxs / np.maximum(count, 1), 0.0)
        return {"cross_correlation": cc,
                "average_intensity": avg.mean(axis=-1),
                "num_images_good": int(n_good)}
