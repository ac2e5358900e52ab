"""IO layer tests: database templating/dispatch, run numbering, VTK output
structure."""
import os

import numpy as np
import pytest

from xframe_tpu.io.database import DefaultDB
from xframe_tpu.io import hdf5


def test_database_templating(tmp_path):
    db = DefaultDB({"thing": "{base}/{name}/run_{run}/thing.h5"},
                   base=str(tmp_path))
    p = db.get_path("thing", name="x", run=3)
    assert p == f"{tmp_path}/x/run_3/thing.h5"
    with pytest.raises(KeyError):
        db.get_path("thing", name="x")  # missing modifier


def test_database_dispatch_and_runs(tmp_path):
    db = DefaultDB({"d": str(tmp_path / "sub" / "d.npy"),
                    "t": str(tmp_path / "t.txt"),
                    "y": str(tmp_path / "y.yaml")})
    db.save("d", np.arange(4))
    assert db.load("d").tolist() == [0, 1, 2, 3]
    db.save("t", "hello")
    assert db.load("t") == "hello"
    db.save("y", {"a": 1, "b": [1, 2]})
    assert db.load("y") == {"a": 1, "b": [1, 2]}
    # run numbering
    folder = str(tmp_path / "runs")
    p1, n1 = DefaultDB.next_run_folder(folder)
    p2, n2 = DefaultDB.next_run_folder(folder)
    assert (n1, n2) == (1, 2)
    assert os.path.isdir(p2)


def test_hdf5_nested_roundtrip(tmp_path):
    data = {
        "arr_c": np.arange(6, dtype=complex).reshape(2, 3) * (1 + 1j),
        "arr_b": np.array([True, False]),
        "nested": {"tup": (1, "two", 3.0), "none": None,
                   "ragged": [np.zeros((2, 2)), np.ones((3, 1))]},
        "scalar": 7,
        "string": "héllo",
    }
    p = str(tmp_path / "t.h5")
    hdf5.save(p, data)
    out = hdf5.load(p)
    assert np.array_equal(out["arr_c"], data["arr_c"])
    assert out["arr_b"].dtype == bool
    assert out["nested"]["tup"] == (1, "two", 3.0)
    assert out["nested"]["none"] is None
    assert np.array_equal(out["nested"]["ragged"][1], np.ones((3, 1)))
    assert out["scalar"] == 7
    assert out["string"] == "héllo"


def test_vtk_output_parses(tmp_path):
    from xframe_tpu.io import vtk
    import xml.etree.ElementTree as ET
    p = str(tmp_path / "g.vts")
    vtk.save_spherical(p, np.linspace(1, 2, 3), np.linspace(0.2, 3.0, 4),
                       np.linspace(0, 6, 5), {"rho": np.ones((3, 4, 5)),
                                              "psi": np.ones((3, 4, 5)) * 1j})
    root = ET.parse(p).getroot()
    assert root.attrib["type"] == "StructuredGrid"
    names = [d.attrib["Name"] for d in root.iter("DataArray")]
    assert "rho" in names and "psi_real" in names and "psi_imag" in names
    assert "Points" in names


def test_pdb_protocol_and_py_access(tmp_path):
    """DefaultDB access-method parity (reference database.py:178-199):
    pdb:// protocol loads atom records / densities, .py loads a module,
    shell extensions round-trip as text."""
    from xframe_tpu.io.database import DefaultDB
    db = DefaultDB()
    pdb_file = tmp_path / "mol.pdb"
    pdb_file.write_text(
        "ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.0"
        "0           N\n"
        "HETATM    2  O   HOH A   2       1.000   2.000   3.000  0.50  0.0"
        "0           O\n")
    atoms = db.load_direct(f"pdb://{pdb_file}")
    assert atoms["positions"].shape == (2, 3)
    assert atoms["electrons"].tolist() == [7.0, 8.0]
    assert atoms["occupancies"].tolist() == [1.0, 0.5]
    grid = np.stack(np.meshgrid(*(np.linspace(-5, 5, 4),) * 3,
                                indexing="ij"), axis=-1)
    rho = db.load_direct(f"pdb://{pdb_file}", grid_cartesian=grid,
                         resolution=6.0)
    assert rho.shape == (4, 4, 4) and rho.sum() > 0

    py_file = tmp_path / "snippet.py"
    db.save_direct(str(py_file), "VALUE = 41 + 1\n")
    mod = db.load_direct(str(py_file))
    assert mod.VALUE == 42

    sh = tmp_path / "run.sh"
    db.save_direct(str(sh), "echo hi\n")
    assert db.load_direct(str(sh)) == "echo hi\n"


def test_io_file_options_toggles(tmp_path, monkeypatch):
    """IO.files.<name>.options save-hook toggles (reference per-name options:
    ccd save_symlink, invariants create_symlink/plot_first_invariants,
    reconstructions generate_vtk_files/plot_error_metrics)."""
    import numpy as np
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    from xframe_tpu.projects.fxs._database_ import ProjectDB
    from xframe_tpu.settings.tools import DictNamespace

    ccd_data = {"radial_points": np.arange(4.0), "angular_points": np.arange(8.0),
                "xray_wavelength": 1.0, "average_intensity": np.ones(4),
                "cross_correlation": {"I1I1": np.ones((4, 4, 8))},
                "num_images_processed": 1, "num_images_good": 1}

    db = ProjectDB(DictNamespace({"structure_name": "s1"}))
    path, _ = db.save_ccd(dict(ccd_data))
    link = os.path.join(os.path.dirname(os.path.dirname(path)), "ccd.h5")
    assert os.path.islink(link)          # save_symlink default True
    # the symlink resolves to the newest run
    path2, _ = db.save_ccd(dict(ccd_data))
    assert os.path.realpath(link) == os.path.realpath(path2)

    db_off = ProjectDB(DictNamespace({
        "structure_name": "s2",
        "IO": {"files": {"ccd": {"options": {"save_symlink": False}}}}}))
    path3, _ = db_off.save_ccd(dict(ccd_data))
    assert not os.path.exists(os.path.join(
        os.path.dirname(os.path.dirname(path3)), "ccd.h5"))

    # reconstructions: vtk + error plot toggles
    rec = {"configuration": {"internal_grid": {
               "real_grid": np.arange(4.0), "reciprocal_grid": np.arange(4.0),
               "thetas": np.linspace(0.1, 3.0, 6),
               "phis": np.linspace(0, 6.2, 8)}},
           "reconstruction_results": {"0": {
               "real_density": np.ones((4, 6, 8)),
               "error_dict": {"main": np.ones(5), "reciprocal": np.ones(5),
                              "final": 1.0}}}}
    db_noviz = ProjectDB(DictNamespace({
        "structure_name": "s3",
        "IO": {"files": {"reconstructions": {"options": {
            "generate_vtk_files": False, "plot_error_metrics": False,
            "plot_first_used_invariants": False,
            "generate_2d_images": False}}}}}))
    p, _ = db_noviz.save_reconstructions(rec)
    folder = os.path.dirname(p)
    assert not any(f.endswith(".vts") or f.endswith(".png")
                   for f in os.listdir(folder))
    db_viz = ProjectDB(DictNamespace({"structure_name": "s4"}))
    p, _ = db_viz.save_reconstructions(rec)
    folder = os.path.dirname(p)
    assert any(f.endswith(".vts") for f in os.listdir(folder))
    assert "errors.png" in os.listdir(folder)
    assert "real_density_0.png" in os.listdir(folder)


def test_invariants_plot_options(tmp_path, monkeypatch):
    """invariants options plot_first_invariants_from_proj_matrices (default
    on) and plot_first_projection_matrix_error_estimates (default off)."""
    import numpy as np
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    from xframe_tpu.projects.fxs._database_ import ProjectDB
    from xframe_tpu.settings.tools import DictNamespace

    rng = np.random.default_rng(0)
    bl = rng.normal(size=(3, 5, 5)) + 0j
    inv = {"deg_2_invariant": {"I1I1": bl},
           "data_projection_matrices": {"I1I1": [rng.normal(size=(5, 1)) + 0j,
                                                 rng.normal(size=(5, 3)) + 0j,
                                                 rng.normal(size=(5, 5)) + 0j]},
           "data_projection_matrix_error_estimates": {
               "I1I1": np.abs(rng.normal(size=(3, 5, 5)))},
           "max_order": 2, "dimensions": 3,
           "data_radial_points": np.linspace(0.1, 1, 5)}
    db = ProjectDB(DictNamespace({"structure_name": "pI"}))
    p, _ = db.save_invariants(dict(inv))
    files = os.listdir(os.path.dirname(p))
    assert "first_invariants.png" in files
    assert "first_invariants_from_proj_matrices.png" in files
    assert "first_projection_matrix_error_estimates.png" not in files

    db2 = ProjectDB(DictNamespace({
        "structure_name": "pII",
        "IO": {"files": {"invariants": {"options": {
            "plot_first_projection_matrix_error_estimates": True}}}}}))
    p, _ = db2.save_invariants(dict(inv))
    assert "first_projection_matrix_error_estimates.png" in \
        os.listdir(os.path.dirname(p))
