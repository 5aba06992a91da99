"""`vlm-parity-torch` (vlm_bridge_tpu_torch.tools.parity): the port's record ->
check round trip and a corrupted transcript refused; across packages, a
transcript the JAX `vlm-parity record` writes from tiny HF snapshots and a
`.pth` bridge is matched token for token by the port's `check` on the same
files; `self-check` needs the reference checkout (skipped without it, as the
JAX test is) and refuses clearly when the module is missing."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_hf_loader import _hf_dinov2, _hf_gemma2
from vlm_bridge_tpu_torch.tools.parity import DEFAULT_REFERENCE, main

needs_reference = pytest.mark.skipif(not Path(DEFAULT_REFERENCE).exists(),
                                     reason="reference checkout not available")


@needs_reference
def test_self_check_tiny(capsys):
    assert main(["self-check", "--dims", "tiny"]) == 0
    assert "PARITY SELF-CHECK PASSED" in capsys.readouterr().out


def test_self_check_without_the_reference_fails_clearly(tmp_path, capsys):
    assert main(["self-check", "--reference", str(tmp_path / "missing.py"),
                 "--dims", "tiny"]) == 2
    assert "reference module not found" in capsys.readouterr().out


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        p = d / f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (80, 96, 3), np.uint8)).save(p)
        paths.append(p)
    return paths


def test_record_then_check_roundtrip(images, tmp_path, capsys):
    transcript = tmp_path / "transcript.jsonl"
    common = ["--preset", "tiny", "--device", "cpu", "--max-length", "6"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    assert main(["record", *map(str, images), "--output", str(transcript), *common]) == 0
    rows = [json.loads(line) for line in transcript.read_text().splitlines()]
    assert len(rows) == 2 and all(r["tokens"][0] == 2 for r in rows)

    assert main(["check", "--transcript", str(transcript), "--data-dir", "/", *common]) == 0
    assert "2/2 matched" in capsys.readouterr().out

    # a corrupted transcript fails the check
    rows[1]["tokens"][2] = (rows[1]["tokens"][2] + 1) % 500
    transcript.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    assert main(["check", "--transcript", str(transcript), "--data-dir", "/", *common]) == 1
    assert "1/2 matched" in capsys.readouterr().out
    # the decode's TF32 switches are restored after it
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == tf32


def test_jax_transcript_matched_by_the_port(images, tmp_path, capsys):
    """JAX records from HF snapshots + a .pth; the port checks the same files."""
    from vlm_bridge_tpu.tools import parity as jparity
    from vlm_bridge_tpu_torch.configs import BridgeConfig
    from vlm_bridge_tpu_torch.models import bridge
    from vlm_bridge_tpu_torch.params.torch_bridge import save_pth

    _, lm = _hf_gemma2(seed=3)
    _, vision = _hf_dinov2(seed=4)
    lm.save_pretrained(tmp_path / "gemma", safe_serialization=True, max_shard_size="150KB")
    vision.save_pretrained(tmp_path / "dino", safe_serialization=True)
    cfg = BridgeConfig.tiny_test()
    g = torch.Generator().manual_seed(5)
    save_pth(bridge.init(cfg, generator=g), cfg, tmp_path / "bridge.pth")
    files = ["--hf-vision-path", str(tmp_path / "dino"), "--hf-lm-path", str(tmp_path / "gemma"),
             "--pth", str(tmp_path / "bridge.pth"), "--dtype", "f32", "--preset", "tiny",
             "--max-length", "8"]
    transcript = tmp_path / "jax.jsonl"
    assert jparity.main(["record", *map(str, images), "--output", str(transcript),
                         "--platform", "cpu", *files]) == 0
    rows = [json.loads(line) for line in transcript.read_text().splitlines()]
    assert len(rows) == 2 and all(len(r["tokens"]) > 1 for r in rows)
    capsys.readouterr()
    assert main(["check", "--transcript", str(transcript), "--data-dir", "/",
                 "--device", "cpu", *files]) == 0
    assert "2/2 matched" in capsys.readouterr().out
