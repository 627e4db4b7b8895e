"""PyTorch port of the SOAPdenovo-Trans assembler in ``soapdenovo_trans_tpu``.

The JAX package stays the reference; this package mirrors its module
names so each function's counterpart is found in the same place.  It
imports ``torch`` and never ``jax``.  Tensors carry an explicit device:
no module picks one on its own.

Conventions shared by every module:

* a k-mer or packed row is an ``(..., W)`` int64 tensor whose lanes hold
  the JAX package's uint32 words (0 <= lane < 2**32), word 0 most
  significant — torch has no unsigned 32-bit shifts on the CPU;
* index tensors are int64; sizes known on the host (table and edge
  counts) are Python ints, and only ``SortedRun.n`` stays a device
  scalar so the counting merges never wait on the host.
"""

__version__ = "0.1.0"
