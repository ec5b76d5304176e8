"""Builds the shared host library before pytest starts any test process.

Both packages bind ``native/libnbf.so``, which is not in git: a fresh
checkout builds it at first use.  The JAX package's loader builds it in
place with ``make`` and keeps a failed load for the life of its process,
and ``tests/test_native.py`` runs that loader while it is collected (its
module-level ``skipif``), in every xdist worker at about the same moment.
pytest reads this file first, in the controlling process before it
starts the workers, so importing the PyTorch port here builds the
library once, under a lock and atomically
(``new_bloom_filter_repo_tpu_torch.utils.native.ensure_built``), and
every loader after it finds a whole library that is fresh.  The import
loads numpy, not torch or JAX.
"""

import new_bloom_filter_repo_tpu_torch  # noqa: F401
