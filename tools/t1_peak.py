"""T1 of a tree's ``chip_smoke.py`` alone, on the card: smollm-360m
training at 16 x 4,096 (``phase_train_lm_full``), its line and its
``max_memory_allocated``.

    python3 tools/t1_peak.py TREE

``TREE`` is the root of a checkout (this one, or another unpacked with
``git archive`` under a directory ``.gitignore`` lists); its ``src`` and
``chip_smoke.py`` are the ones imported. To compare two trees' peaks,
run both in one chip call on one card.
"""

import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(tree, "src"))
sys.path.insert(0, tree)
import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs  # noqa: E402

print(cs._device_line(), "tree", tree, flush=True)
_, _, sec, peak = cs.phase_train_lm_full()
print("T1_PEAK", tree, peak, sec, flush=True)
