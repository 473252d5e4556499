"""Camera and the on-device preprocess."""
