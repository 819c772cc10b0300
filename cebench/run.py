"""One run of one benchmark cell of the PyTorch port:

    python3 cebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (see ``cebench/README.md``). Exits non-zero, with no result, where
there is no card or too few, where a file the cell names is missing, or
where JAX or the JAX package was loaded.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    import torch
    from cebench.harness import core
    torch.set_num_threads(2)      # one process, few host threads
    sys.exit(core.main(root=ROOT))
