"""Whisper (encoder-decoder ASR) in PyTorch, for transcribing a cloning
reference that comes without its transcript.

Counterpart of ``t5gemma_tts_tpu/asr/``:

  mel.py      log-mel features (WhisperFeatureExtractor's), the Slaney
              filter bank written in numpy and ``torch.fft.rfft``
  model.py    functional encoder / decoder and the KV-cached decode loop
  convert.py  HF Whisper state dict -> parameter tree (key-exhaustive)

Plain PyTorch in f32: the JAX package's Whisper has no Pallas kernel.
"""
