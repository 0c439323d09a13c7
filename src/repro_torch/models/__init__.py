"""Model code of the port: parameter metadata, layers, GQA attention and
the decoder LM, mirroring ``repro/models``."""
