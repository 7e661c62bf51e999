"""Core protocol math of the port: SQS/SLQ, conformal control, bits,
verification, the wire codecs and the engine."""
