"""The PC object model, ported (port of ``repro.objectmodel``).

Host side: page-as-a-heap allocation, offset Handles, buffer pool, paged
record stores, vector lists and typed record schemas, copies of the
reference's numpy modules. Device side: the paged KV cache's page
allocator (``kvcache``, imported on its own: it loads torch).
"""
from repro_torch.objectmodel.page import (AllocPolicy, OutOfPageMemory, Page,
                                          PageAllocator, DEFAULT_PAGE_SIZE)
from repro_torch.objectmodel.handle import (GLOBAL_TYPES, HANDLE_DTYPE,
                                            NULL_HANDLE, Handle, TypeRegistry,
                                            deep_copy, deref, make_object,
                                            make_vector)
from repro_torch.objectmodel.vectorlist import VectorList
from repro_torch.objectmodel.pool import BufferPool, PageState
from repro_torch.objectmodel.store import PagedSet, PagedStore
from repro_torch.objectmodel.schema import (Field, Record, boolean, f32, f64,
                                            i8, i16, i32, i64, pair_schema,
                                            record, schema_for, u8, u16, u32,
                                            u64, vector, S, U)

__all__ = [
    "AllocPolicy", "OutOfPageMemory", "Page", "PageAllocator",
    "DEFAULT_PAGE_SIZE", "GLOBAL_TYPES", "HANDLE_DTYPE", "NULL_HANDLE",
    "Handle", "TypeRegistry", "deep_copy", "deref", "make_object",
    "make_vector", "VectorList", "BufferPool", "PageState", "PagedSet",
    "PagedStore",
    "Field", "Record", "record", "schema_for", "pair_schema",
    "i8", "i16", "i32", "i64", "u8", "u16", "u32", "u64",
    "f32", "f64", "boolean", "S", "U", "vector",
]
