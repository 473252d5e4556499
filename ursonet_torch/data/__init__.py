"""The URSO adapter, the PNG codec, synthetic frames, the host loader
and the on-device preprocess."""
