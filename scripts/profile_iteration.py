#!/usr/bin/env python
"""Component timing of the MTIP iteration at tutorial scale: isolates the
spherical FT, the intensity projection, and the Procrustes step to steer
kernel optimization. Run it alone on a GPU (one process per card)."""
import time

import numpy as np
import jax
import jax.numpy as jnp

from xframe_tpu.library.compile_cache import enable as enable_cache
from xframe_tpu.projects.fxs.demo import make_demo_problem

enable_cache()
from xframe_tpu.projects.fxs.phasing import Segment


def timed(fn, *args, n=20, warmup=True):
    if warmup:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    B = 4
    p = make_demo_problem(128, 64, n_theta=256, n_phi=512,
                          procrustes_method="newton_schulz")
    ft, mtip = p.ft, p.mtip
    rho = p.initial_density_batch(0, B)

    fwd = jax.jit(jax.vmap(ft.forward))
    t_ft = timed(fwd, rho)
    psi = fwd(rho)

    sht_fwd = jax.jit(jax.vmap(lambda ps: ft.sht.forward_real(
        (ps * ps.conj()).real)))
    t_sht = timed(sht_fwd, psi)
    Ilm = sht_fwd(psi)

    proc = jax.jit(jax.vmap(mtip.rc.approximate_unknowns))
    t_proc = timed(proc, Ilm)

    proj = jax.jit(jax.vmap(lambda I: mtip.rc(I)))
    t_proj = timed(proj, Ilm)

    synth = jax.jit(jax.vmap(lambda c: ft.sht.inverse(c).real))
    t_synth = timed(synth, proj(Ilm))

    step = jax.jit(jax.vmap(lambda r: mtip.mtip_iteration(
        r, jnp.asarray(mtip.initial_support), jnp.float32(0.5), "HIO", True)[0]))
    t_full = timed(step, rho, n=10)

    print(f"batch={B} tutorial scale (128, 256x512), times per call:")
    print(f"  spherical FT (fwd)          : {t_ft*1e3:8.2f} ms")
    print(f"  intensity SHT (fwd_real)    : {t_sht*1e3:8.2f} ms")
    print(f"  procrustes (NS polar)       : {t_proc*1e3:8.2f} ms")
    print(f"  full data projection        : {t_proj*1e3:8.2f} ms")
    print(f"  intensity synthesis (iSHT)  : {t_synth*1e3:8.2f} ms")
    print(f"  FULL MTIP iteration         : {t_full*1e3:8.2f} ms"
          f"  ({t_full/B*1e3:.2f} ms/restart)")
    # rough decomposition: iteration ~ 3 FT-equivalents + projection chain
    print(f"  (3x FT + SHT pair + proj    : "
          f"{(3*t_ft + t_sht + t_synth + t_proj)*1e3:8.2f} ms expected)")




def ft_breakdown():
    import jax.numpy as jnp
    B = 4
    p = make_demo_problem(128, 64, n_theta=256, n_phi=512)
    ft = p.ft
    rho = p.initial_density_batch(0, B)

    sht_fwd = jax.jit(jax.vmap(ft.sht.forward))
    c = sht_fwd(rho)
    t_a = timed(sht_fwd, rho)
    hank = jax.jit(jax.vmap(ft.hankel.forward))
    t_h = timed(hank, c)
    sht_inv = jax.jit(jax.vmap(ft.sht.inverse))
    t_s = timed(sht_inv, c)
    fft_only = jax.jit(lambda x: jnp.fft.fft(x, axis=-1))
    t_f = timed(fft_only, rho)
    print(f"  SHT analysis (fold+einsums+fft): {t_a*1e3:8.2f} ms")
    print(f"  Hankel (batched per-l matmul)  : {t_h*1e3:8.2f} ms")
    print(f"  SHT synthesis (einsums+ifft)   : {t_s*1e3:8.2f} ms")
    print(f"  bare FFT over phi              : {t_f*1e3:8.2f} ms")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--ft", action="store_true")
    a = ap.parse_args()
    if a.ft:
        ft_breakdown()
    else:
        main()
