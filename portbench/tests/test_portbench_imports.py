"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the program; top-level names compared
whole (the port's name begins with the JAX package's)."""

import ast
import os

from portbench import registry, runner

HERE = registry.HERE


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for base, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: sorted(set(_imports(p)) & set(runner.FORBIDDEN))
             for p in _sources()}
    assert not any(found.values()), found


def test_references_import_nothing_of_the_program():
    folder = os.path.join(HERE, "reference")
    for f in os.listdir(folder):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(folder, f)))
            assert names <= {"__future__", "numpy", "torch", "scipy",
                             "math", "itertools"}, (f, names)


def test_the_run_check_compares_whole_names():
    assert runner.forbidden_modules(["manisdp_tpu_torch",
                                     "manisdp_tpu_torch.kernels",
                                     "jaxtyping", "torch"]) == []
    assert runner.forbidden_modules(["manisdp_tpu.solvers", "jax.numpy",
                                     "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "manisdp_tpu"]
