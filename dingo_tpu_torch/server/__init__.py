"""Serving ingress of the port: ``services.IndexService`` binds a
SearchCoalescer to VectorIndexWrappers."""
