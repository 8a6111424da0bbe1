"""calibrate.py for the motion cell, with its own fault beside the shared
ones (harness/motion.py: ``half_frames``, half of the step's CLIP frames
left out):

    python3 benchmark/calibrate_motion.py --workload motion-optimizer.adam --seeds 1,2,3 \
        --control tf32 --faults half_frames,altered,unchanged --fault-seeds 3 --out <file.json>
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import calibrate  # noqa: E402
from benchmark.harness import faults, motion  # noqa: E402

if __name__ == "__main__":
    faults.FAULTS.update(motion.FAULTS)
    sys.exit(calibrate.main())
