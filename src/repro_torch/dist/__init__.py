"""dist (PyTorch port): ranks over ``torch.distributed`` for the
hybrid-parallel collection: a rank's place in the mesh (``mesh``), the
process-group bring-up (``group``), the sharding rules and a rank's slice
of a state (``partitioning``), the exchange between shards (``exchange``)
and the rank worker (``run``)."""
