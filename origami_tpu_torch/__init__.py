"""origami_tpu_torch — the PyTorch/CUDA port of origami_tpu.

The JAX package `origami_tpu` is the reference; this package imports
nothing from it (nor jax, flax, PIL, click, msgpack or cv2) and keeps its
own copies of what it needs, under the same module paths where that helps
a reader find the counterpart.

Slices ported so far
--------------------
batch.detect.ocr   the OCR stage: dewarp the page, cut each text line into
                   a 48-px strip, run the CNN+BiLSTM+CTC recognizer, write
                   ocr.zip (`python -m origami_tpu_torch.batch.detect.ocr`)

Subpackages
-----------
models     recognizer (nn.Module), CTC decoding, model registry, msgpack
core       Page, dewarp Grid, blocks/lines, a small PNG reader
ops        the hand-written CUDA kernels' wrappers and plain versions
csrc       CUDA C++ sources of the kernels (built with nvcc at first use)
batch      the batch runtime (Processor, Reader/Writer, mutex) + stages

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`--device cpu`); without a card they raise (see `device.resolve`).
"""

__version__ = "0.1.0"
