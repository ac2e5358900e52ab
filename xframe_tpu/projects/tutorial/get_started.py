"""Tutorial project: a minimal ProjectWorker demonstrating the framework
shell (reference xframe/projects/tutorial/): settings tree, database
archiving, and a small device computation.

Run:  python -m xframe_tpu tutorial get_started
"""
from __future__ import annotations

import numpy as np
import jax

from xframe_tpu.interfaces import ProjectWorkerInterface
from xframe_tpu.io.database import DefaultDB
from xframe_tpu.settings import loader as settings_loader


class TutorialDB(DefaultDB):
    def __init__(self, settings=None):
        super().__init__({
            "result": "{home}/data/tutorial/run_{run}/result.h5",
        })


class ProjectWorker(ProjectWorkerInterface):
    database_class = TutorialDB

    def run(self):
        opt = self.settings
        n = int(opt.get("n_points", 64))
        radius = float(opt.get("radius", 10.0))

        from xframe_tpu.ops.fourier import SphericalFourierTransform
        from xframe_tpu.library.shapes import spherical_grid, ball_density
        ft = SphericalFourierTransform(n, int(opt.get("max_order", 8)),
                                       q_max=float(opt.get("max_q", 0.5)))
        grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
        rho = ball_density(grid, radius)

        @jax.jit
        def intensity_of(r):
            psi = ft.forward(r.astype("complex64"))
            return (psi * psi.conj()).real
        intensity = np.asarray(intensity_of(np.asarray(rho, dtype=np.float32)))
        import os
        folder = os.path.join(settings_loader.home_dir(), "data", "tutorial")
        run_path, run = self.db.next_run_folder(folder)
        self.db.save_direct(os.path.join(run_path, "result.h5"), {
            "radial_points": ft.qs,
            "intensity_q00": intensity[:, 0, 0],
            "settings_used": {"n_points": n, "radius": radius},
        })
        print(f"tutorial: ball of radius {radius} -> intensity profile saved "
              f"to {run_path}/result.h5")
        return intensity
