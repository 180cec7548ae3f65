"""Build the port's CUDA kernels from the sources in `csrc/`, at first use.

One `torch.utils.cpp_extension.load` call compiles every source together
(ninja runs one compiler per source in parallel) for `sm_90a`, links them
into one extension and imports it. The build lands in `_build/` beside this
file, which .gitignore lists; `load` reuses it while the sources are
unchanged. Only the sources of this directory go in.

    from bert_pytorch_tpu_torch.ops.kernels.build import load_kernels
    ext = load_kernels()          # builds once per process, then cached
"""

from __future__ import annotations

import os
import threading

KERNELS_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(KERNELS_DIR, "csrc")
BUILD_DIR = os.path.join(KERNELS_DIR, "_build")
SOURCES = ("binding.cpp", "layernorm.cu", "flash_attention.cu",
           "flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "flash_attention_split_bwd.cu", "fused_optim.cu")
EXTENSION_NAME = "bert_pytorch_tpu_torch_kernels"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_ext = None


def load_kernels(verbose: bool = False):
    """The compiled extension module (`layer_norm_fwd`, `layer_norm_bwd`,
    `add_dropout_layer_norm_fwd`, `add_dropout_layer_norm_bwd`,
    `flash_attention_fwd`, `flash_attention_bwd_dq`,
    `flash_attention_bwd_dkv`, `flash_attention_bwd` (the fused backward),
    `flash_bwd_fused_info`, `flash_fwd_info`, `flash_split_bwd_info`,
    `flash_tiles`, the flash kernels' tile sizes, and `lamb_stage1`, `lamb_stage2`). Raises if CUDA
    or the toolchain is missing — there is no other route to the
    kernels."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            # load() takes a lock file inside the build directory, so the
            # directory must exist first
            os.makedirs(BUILD_DIR, exist_ok=True)
            _ext = load(
                name=EXTENSION_NAME,
                sources=[os.path.join(CSRC_DIR, s) for s in SOURCES],
                build_directory=BUILD_DIR,
                extra_include_paths=[CSRC_DIR],
                extra_cflags=["-O2"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                verbose=verbose)
    return _ext
