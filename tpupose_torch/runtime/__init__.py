"""Host runtime: the decode-ahead frame loader (`runtime.loader`) and the
ingest measurements (`runtime.ingest_bench`)."""
