"""Scale-out helpers: input sharding and the ordered SAM merge."""
