"""A rank of a run with a fault planted: python -m
portbench.tests.fault_rank <fault> <portbench.run arguments>."""

import sys

from portbench import run
from portbench.tests import faults

if __name__ == "__main__":
    faults.plant(sys.argv[1])
    # The ranks this one starts carry the same fault.
    sys.exit(run.main(sys.argv[2:], prefix=[
        sys.executable, "-m", "portbench.tests.fault_rank", sys.argv[1]]))
