"""Weight conversion, the msgpack codec, the checkpoint store and the
int8 serving artifact, all in the JAX package's layout."""
