"""Run one cell of the benchmark once.

    python3 omnibench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is the result, one JSON object;
the numbers ``correct`` compares, each with its limit, are the last
lines of standard error.  Without a card, or outside a checkout that
holds the port (``src/repro_torch``), it exits non-zero and prints no
result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the port's kernel caches stay at fixed paths inside the checkout (the
# port builds its CUDA libraries under build/torch_ext/ by itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "omnibench" / sub)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"error: no src/repro_torch under {ROOT}: the port is not in this checkout",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from omnibench import harness
    return harness.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
