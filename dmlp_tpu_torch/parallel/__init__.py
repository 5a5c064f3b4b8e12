"""The mesh layer of the port: the ("data", "query") ``DeviceMesh``
(:mod:`.mesh`), the collectives that merge and move candidate lists
(:mod:`.collectives`), and process bring-up, the local launcher and the
per-rank sharded feed (:mod:`.distributed`)."""
