"""Window-batched search engine (the production usearch_global path).

The serial reference loop (src/search.cpp:51-87) becomes: rank a window
of queries at once, HSP-chain the next candidate of every live query,
align the DP holes as one device batch (ops/wavefront_nw.py), then
replay accept/terminate per query — bit-identical outputs with the DP
and ranking batched into device-sized dispatches.
"""

from .batch import BatchEngine, engine_eligible
