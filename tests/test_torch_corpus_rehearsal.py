"""The port's rehearsal of the real ICBHI corpus path, on the CPU: the port
of tests/test_corpus_rehearsal.py.

The real download is not in the repository, so these tests drive the
pipeline a user runs on it through the port: the corpus fixture (mixed
native rates 4 / 10 / 44.1 kHz, the real file-name grammar, CRLF endings,
trailing whitespace and tabs, a stray header, zero-length cycles, missing
trailing newlines) -> segmenter -> segmented dataset -> a 2-epoch
TrainerWithICBHI -> Validator -> ClassifierEngine.classify_file on an
original 44.1 kHz recording, all with device="cpu".
"""

import numpy as np
import pytest

from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.segmenter import ICBHISegmenter
from audio_classification_icbhi_tpu_torch.data.synthetic import generate_icbhi_corpus_fixture
from audio_classification_icbhi_tpu_torch.data.wavio import read_wav
from audio_classification_icbhi_tpu_torch.inference import ClassifierEngine
from audio_classification_icbhi_tpu_torch.models import build_model
from audio_classification_icbhi_tpu_torch.training.trainer_icbhi import TrainerWithICBHI
from audio_classification_icbhi_tpu_torch.training.validation import Validator
from audio_classification_icbhi_tpu_torch.utils.checkpoint import load_checkpoint
from audio_classification_icbhi_tpu_torch.utils.icbhi_metrics import calculate_icbhi_score
from test_corpus_rehearsal import corpus_config

SR = 4000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("icbhi_corpus")
    generate_icbhi_corpus_fixture(root, num_recordings=16, cycles_per_recording=5, seed=3)
    return root


@pytest.fixture(scope="module")
def segmented(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("icbhi_segmented")
    seg = ICBHISegmenter(corpus / "audio_and_txt_files", out, sample_rate=SR)
    seg.process_all()
    return out, seg.stats


class TestCorpusFixtureETL:
    def test_segmenter_survives_corpus_grit(self, segmented):
        out, stats = segmented
        assert stats["processed_files"] == 16
        # 16 x 5 cycles, less the zero-length cycles (every fourth
        # recording) that min_duration skips
        assert stats["total_segments"] > 0
        assert stats["skipped_segments"] >= 4
        assert stats["total_segments"] + stats["skipped_segments"] >= 16 * 5
        for d in ("normal", "crackle", "wheeze", "both"):
            assert stats[d] > 0
            assert any((out / d).glob("*.wav")), d

    def test_segments_resampled_to_target_rate(self, segmented):
        out, _ = segmented
        for d in ("normal", "crackle", "wheeze", "both"):
            for wav in sorted((out / d).glob("*.wav"))[:3]:
                data, sr = read_wav(wav)
                assert sr == SR
                assert data.shape[-1] >= int(0.5 * SR)

    def test_whole_recording_dataset_mixed_rates(self, corpus, tmp_path):
        ds = ICBHIDataset(corpus, "train", corpus_config(tmp_path))
        assert len(ds) > 0
        for i in range(len(ds)):
            wave, label = ds[i]
            assert wave.shape == (SR,) and wave.dtype == np.float32
            assert 0 <= label <= 3 and np.all(np.isfinite(wave))


class TestCorpusFixtureTrainValidate:
    def test_train_validate_classify_e2e(self, corpus, segmented, tmp_path):
        out, _ = segmented
        config = corpus_config(tmp_path)
        train = ICBHISegmentedDataset(out, "train", config, augment=True)
        val = ICBHISegmentedDataset(out, "val", config, augment=False)
        assert len(train) > 0 and len(val) > 0

        trainer = TrainerWithICBHI(build_model(config), train, val, config, device="cpu")
        history = trainer.train()
        assert len(history["train_loss"]) == 2 and len(history["icbhi_score"]) == 2
        assert all(np.isfinite(history["train_loss"])) and all(np.isfinite(history["val_loss"]))

        ckpt_path = tmp_path / "ckpts" / "best_model.ckpt"
        ckpt = load_checkpoint(ckpt_path)
        assert ckpt["config"]["data"]["sample_rate"] == SR
        assert ckpt["icbhi_score"] == max(history["icbhi_score"])

        # the best checkpoint through the Validator, as validate_icbhi runs it
        eng = ClassifierEngine(ckpt_path, device="cpu")
        test = ICBHISegmentedDataset(out, "test", eng.config)
        y_true, y_pred, y_prob = Validator(eng.model, test, eng.config, device="cpu").validate()
        assert len(y_true) == len(test) > 0 and y_prob.shape == (len(test), 4)
        np.testing.assert_allclose(y_prob.sum(-1), 1.0, atol=1e-5)
        score = calculate_icbhi_score(y_true, y_pred)["icbhi_score"]
        assert 0.0 <= score <= 1.0

        # the CLI's classify on an original 44.1 kHz recording
        wav_441 = sorted((corpus / "audio_and_txt_files").glob("*Meditron.wav"))[0]
        res = eng.classify_file(wav_441)
        assert res["predicted_class"] in config["classes"]
        assert 0.0 <= res["confidence"] <= 1.0
        probs = np.asarray(list(res["probabilities"].values()), dtype=np.float64)
        assert probs.shape == (4,) and abs(probs.sum() - 1.0) < 1e-3
