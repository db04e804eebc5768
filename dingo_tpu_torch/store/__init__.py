"""Store-side runtime (port of dingo_tpu/store): regions, the meta
manager and the store node's region lifecycle."""
