"""The converted store's codecs, without orbax or tensorstore: zstd
(:mod:`.zstd`, libzstd through ctypes), CRC-32C (:mod:`.crc32c`), the OCDBT
database (:mod:`.ocdbt`) and zarr v2 arrays (:mod:`.zarr`). The store
itself is :mod:`trlx_tpu_torch.checkpointing`."""
