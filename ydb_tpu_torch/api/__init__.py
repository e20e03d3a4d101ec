"""api/ — the port's protocol fronts: the PostgreSQL wire server
(``pgwire.py``). The gRPC, Kafka and SQS fronts of the reference's
``ydb_tpu/api`` wait for their ROADMAP.md queue A items."""
