"""Core protocol math of the port: SQS/SLQ, conformal control, bits,
verification, the wire codecs, the channel and its shared links, the
paged-KV allocator and the engine."""
