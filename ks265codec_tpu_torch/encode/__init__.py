"""Encoder host modules. config, map_writer, sao and sbac are
byte-for-byte copies of the same files in ks265codec_tpu/encode
(tests/test_torch_port.py checks the copies); intra_frame and encoder
are the port's own all-intra encoder."""
