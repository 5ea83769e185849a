"""Input pipeline: the native shuffling loader, its buffer pool, the
K-block stacker and the depth-N device prefetcher."""
from autodist_tpu_torch.data.loader import (BlockStacker, BufferPool,  # noqa: F401
                                            DevicePrefetcher,
                                            NativeDataLoader,
                                            write_record_file)
