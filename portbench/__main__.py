"""``python3 -m portbench``: see ``portbench/run.py``."""

import sys

from portbench.run import main

sys.exit(main())
