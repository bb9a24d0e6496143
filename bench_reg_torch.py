"""gsjax's `bench_reg.py` run through gsjax_torch on the card (`gsjax_torch/bench_reg.py`
says what it measures, its environment variables and how to run it tiny on
the CPU).

    python3 bench_reg_torch.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gsjax_torch.bench_reg import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
