"""Host-side data substrate (carried over): table ingest, HDF5 dict store,
observable sorting/filtering and (design, feature) matrix assembly."""
