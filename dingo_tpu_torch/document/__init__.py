"""Document subsystem: per-region full-text index (port of
dingo_tpu/document/__init__.py).

Mirrors reference src/document/ (DocumentIndex over the vendored Rust
tantivy-search, document_index.h; DocumentIndexManager; DocumentReader).
No Rust exists in this image, so the index is an original BM25 inverted
index (documents are also persisted in the engine; the index is an
apply-log-tracked materialized view exactly like the vector index).
"""

from dingo_tpu_torch.document.index import DocumentIndex  # noqa: F401
