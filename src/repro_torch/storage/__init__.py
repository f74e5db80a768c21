"""Raw padded-CSR vector store (the exact rerank source)."""
