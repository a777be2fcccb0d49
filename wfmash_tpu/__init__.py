"""wfmash-tpu: a JAX whole-genome / pangenome aligner.

A from-scratch reimplementation of the capabilities of wfmash
(https://github.com/waveygang/wfmash): MashMap3-style minmer sketching and
Jaccard-based approximate mapping, chaining / plane-sweep / scaffold
filtering, and WFA (wavefront) base-level alignment — redesigned for an
accelerator (an NVIDIA GPU) with a native C++ host runtime:

* hashing / sketching / mapping statistics as batched JAX ops,
* thousands of small WFA problems solved per device call (a CUDA kernel
  on the GPU, its plain-JAX twin elsewhere), exact sweeps in XLA,
* the mapping post-pipeline as vectorized array ops over mapping batches,
* multi-device scale-out via `jax.sharding` meshes (sharded target index,
  data-parallel segment batches).

Layering (bottom-up), mirroring SURVEY.md §7:

  io/        host-side FASTA (.fai/.gzi) access, PanSN sequence id manager, PAF
  sketch/    MurmurHash3_x64_128 (bit-exact, seed 42), canonical k-mer hashing,
             bottom-s fragment sketches, windowed minmer extraction
  index/     the target minmer index (CSR posting table) + binary persistence
  map/       L1/L2 mapping stages, chaining, plane-sweep & scaffold filters
  align/     WFA alignment (JAX, CUDA, host spec), CIGAR post-processing,
             the wflign-equivalent patching pipeline
  parallel/  device-mesh sharding helpers for multi-device runs
"""

__version__ = "0.1.0"

# Version string reported by the CLI; mirrors the reference's
# skch::fixed::VERSION ("3.5.0", map_parameters.hpp:129) for feature parity.
WFMASH_COMPAT_VERSION = "3.5.0"
