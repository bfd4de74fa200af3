"""Decoder of the port. `decoder.py` is the port's own HevcDecoder; the
other modules are byte-for-byte copies of the same files in
ks265codec_tpu/decode (tests/test_torch_port.py checks the copies)."""
