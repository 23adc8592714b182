"""The one wall-clock seam for latency telemetry, mirroring
``kube_batch_tpu/utils/telemetry.py``.

Latency metrics measure how long the real compute took, never scenario
time, so they read the wall clock even where the loop's pacing follows an
injected clock.  Every such read in the scheduling core goes through this
module: ``grep -rn 'telemetry.perf_counter'`` lists them all.
"""

import time

#: the wall-clock monotonic high-resolution counter, for latency spans only
perf_counter = time.perf_counter
