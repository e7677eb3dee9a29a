"""One run of one benchmark cell of the PyTorch port (manisdp_tpu_torch).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with a CUDA card.  The cell
is found by name in BENCHMARK.json; its configuration, traffic mix,
instance generator, reference and per-layer metrics are files under
portbench/ found by name (portbench/README.md).  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its
limit).  Without a card, or without the port's package, the run exits
non-zero and prints no result.
"""

import os
import sys
import time

# set-up is timed from here: interpreter start-up is the same on both
# sides of a comparison and is left out
T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# host threads of the solver's numpy / scipy / torch CPU work: few and
# fixed, so runs on a shared host spread less
HOST_THREADS = 4


def _pin_environment():
    """Caches at fixed paths inside the checkout, fixed host threads, and
    no JAX loaded by any library (before numpy or torch is imported)."""
    cache = os.path.join(ROOT, "build", "portbench")
    for key, sub in (("CUDA_CACHE_PATH", "nv_compute_cache"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[key] = os.path.join(cache, sub)
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[key] = str(HOST_THREADS)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    _pin_environment()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import runner
    return runner.main(argv, t_start=T_START, host_threads=HOST_THREADS)


if __name__ == "__main__":
    sys.exit(main())
