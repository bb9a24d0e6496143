"""gsjax's `bench_scaling.py` run through gsjax_torch on the card (`gsjax_torch/bench_scaling.py`
says what it measures, its environment variables and how to run it tiny on
the CPU).

    python3 bench_scaling_torch.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gsjax_torch.bench_scaling import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
