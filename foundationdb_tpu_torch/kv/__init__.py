"""Key-value core of the port: its own copies of ``foundationdb_tpu/kv``'s
mutation types, atomic ops, MVCC window maps, key-range map, key
selectors, disk queue, memory engine and native B-tree engine, with the
same names and semantics."""
