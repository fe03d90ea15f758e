"""Device mesh + sharded rendering (collectives via shard_map)."""
