"""The host strip path of the OCR stage (`--decoder beam`): the port's
RecognizerPredictor.predict against the JAX one on the same strips.

Strips: the first lines of the `small` fixture page as the port cuts
them (CPU). Both predictors load models_pretrained/recognizer in the
default numeric mode (bf16 convolutions, f32 LSTM) and beam-decode on
the host. Tolerance: at most one of the lines may read differently (bf16
convolutions round at other places in PyTorch and XLA), and the texts
must be non-empty.
"""

from pathlib import Path

import numpy as np
import torch

from origami_tpu.batch.detect.ocr import RecognizerPredictor as JaxPredictor
from origami_tpu_torch.batch.core.io import Artifact, Input, Stage
from origami_tpu_torch.batch.core.lines import LineExtractor
from origami_tpu_torch.batch.detect.ocr import RecognizerPredictor

ROOT = Path(__file__).resolve().parent.parent
MODEL = ROOT / "models_pretrained/recognizer"


class _Proc:
    device = torch.device("cpu")

    @staticmethod
    def lock_or_open(path, mode):
        return open(path, mode)


def _strips(n=8):
    page = next((ROOT / "tests/data/torch_ocr/small").glob("*.png"))
    reader = Input(Artifact.LINES, Artifact.TABLES,
                   stage=Stage.RELIABLE).instantiate(page, _Proc())
    ext = LineExtractor(reader.tables, 48, {},
                        min_confidence=reader.lines.min_confidence,
                        max_width=2048)
    out = []
    for paths, dev, widths, _ in ext.device_groups(
            ext.parts(reader.lines.by_path)):
        s = dev.numpy()
        out += [(p, s[i, :, : widths[i]]) for i, p in enumerate(paths)]
    return out[:n]


def test_beam_decoder_matches_jax():
    strips = _strips()
    port = RecognizerPredictor([MODEL], "cpu", decoder="beam")
    ref = JaxPredictor([MODEL], decoder="beam")
    texts, confs = port.predict(strips)
    jtexts, jconfs = ref.predict(strips)
    differ = [(p, a, b) for (p, _), a, b in zip(strips, texts, jtexts)
              if a != b]
    print(differ)
    assert len(differ) <= 1
    assert all(texts)
    same = [i for i, (a, b) in enumerate(zip(texts, jtexts)) if a == b]
    np.testing.assert_allclose(np.asarray(confs)[same],
                               np.asarray(jconfs)[same], atol=1e-2)
