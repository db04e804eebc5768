"""Engines (port of dingo_tpu/engine): raw KV storage, the raft and mono
replication engines, apply, and the Storage facade."""
