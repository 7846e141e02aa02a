"""One-process input sharding, SAM shards and their merge
(dist/multihost.py)."""
