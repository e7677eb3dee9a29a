"""The port's copied host modules (config, Gset loader, checkpoint,
recipes, SeDuMi container, workload generators) agree with the JAX
package's originals, and importing the port loads no jax."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import manisdp_tpu.config as jcfg
import manisdp_tpu.frontends.gset as jgset
import manisdp_tpu.utils.checkpoint as jckpt
import manisdp_tpu_torch.config as tcfg
import manisdp_tpu_torch.frontends.gset as tgset
import manisdp_tpu_torch.utils.checkpoint as tckpt
from manisdp_tpu_torch.convert import options_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("rel", ["config.py", "frontends/gset.py",
                                 "utils/checkpoint.py", "recipes.py",
                                 "frontends/sedumi.py",
                                 "frontends/workloads.py",
                                 "frontends/sdpa.py", "frontends/convert.py",
                                 "frontends/moments.py",
                                 "frontends/stls.py", "frontends/snl.py",
                                 "frontends/lasserre.py",
                                 "frontends/monomials.py"])
def test_copied_module_is_identical(rel):
    with open(os.path.join(REPO, "manisdp_tpu", rel)) as f:
        original = f.read()
    with open(os.path.join(REPO, "manisdp_tpu_torch", rel)) as f:
        copy = f.read()
    assert copy == original


def test_solver_options_fields_match():
    jf = {f.name: (f.default, f.type)
          for f in dataclasses.fields(jcfg.SolverOptions)}
    tf = {f.name: (f.default, f.type)
          for f in dataclasses.fields(tcfg.SolverOptions)}
    assert tf == jf


@pytest.mark.parametrize("variant", sorted(jcfg.VARIANT_DEFAULTS))
def test_variant_defaults_match(variant):
    assert tcfg.VARIANT_DEFAULTS[variant] == jcfg.VARIANT_DEFAULTS[variant]
    jo = dataclasses.asdict(jcfg.merged_options(variant, tol=1e-7))
    to = dataclasses.asdict(tcfg.merged_options(variant, tol=1e-7))
    assert to == jo
    assert dataclasses.asdict(options_from_dict(jo)) == jo


def test_options_from_dict_rejects_unknown_field():
    d = dataclasses.asdict(jcfg.SolverOptions())
    d["not_an_option"] = 1
    with pytest.raises(ValueError, match="not_an_option"):
        options_from_dict(d)


def test_gset_loader_copy_same(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text("5 6\n1 2 1\n2 3 1\n3 4 -1\n4 5 1\n5 1 1\n1 3 2\n")
    Lj = jgset.load_gset_laplacian(str(path)).toarray()
    Lt = tgset.load_gset_laplacian(str(path)).toarray()
    np.testing.assert_array_equal(Lt, Lj)
    np.testing.assert_array_equal(tgset.maxcut_cost(str(path)).toarray(),
                                  -0.25 * Lj)


def test_checkpoint_copy_same(tmp_path):
    rs = np.random.RandomState(0)
    Y = rs.randn(3, 7)
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    jckpt.save_state(str(a), Y=Y, iteration=4)
    tckpt.save_state(str(b), Y=Y, iteration=4)
    for load in (jckpt.resume_kwargs, tckpt.resume_kwargs):
        for path in (a, b):
            np.testing.assert_array_equal(load(str(path))["Y0"], Y)
    assert tckpt.load_state(str(a)).keys() == jckpt.load_state(str(b)).keys()


def test_import_loads_no_jax():
    code = ("import sys, manisdp_tpu_torch, manisdp_tpu_torch.convert, "
            "manisdp_tpu_torch.kernels, manisdp_tpu_torch.recipes, "
            "manisdp_tpu_torch.ops.sparse, manisdp_tpu_torch.manifolds, "
            "manisdp_tpu_torch.solvers.primal_al, "
            "manisdp_tpu_torch.solvers.general, "
            "manisdp_tpu_torch.solvers.unitdiag, "
            "manisdp_tpu_torch.solvers.unittrace, "
            "manisdp_tpu_torch.solvers.dispatch, "
            "manisdp_tpu_torch.ops.dense_cert, "
            "manisdp_tpu_torch.frontends.workloads, "
            "manisdp_tpu_torch.frontends.sdpa, "
            "manisdp_tpu_torch.frontends.convert, "
            "manisdp_tpu_torch.frontends.moments, "
            "manisdp_tpu_torch.frontends.stls, "
            "manisdp_tpu_torch.frontends.snl, "
            "manisdp_tpu_torch.frontends.lasserre, "
            "manisdp_tpu_torch.frontends.monomials\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'manisdp_tpu' or "
            "m.startswith('manisdp_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_never_import_jax():
    """Every import statement of the port and chip_smoke.py, at any depth
    (docstrings that quote the JAX package do not count)."""
    root = os.path.join(REPO, "manisdp_tpu_torch")
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "manisdp_tpu"), \
                    (path, node.lineno)
