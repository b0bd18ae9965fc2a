// Native spillable chunk store — the C++ tier of the host data cache.
//
// Reference analogue: flink-ml-iteration's MemorySegment-backed datacache
// (DataCacheWriter.java:37 — memory segment pool spilling to file segments,
// DataCacheReader, DataCacheSnapshot). The reference implements this in managed
// Java over Flink's memory manager; here it is a small C++ runtime component:
// an append-only log of byte chunks held in malloc'd memory up to a budget,
// spilling whole chunks to files beyond it, with random-access reads.
//
// C ABI (consumed via ctypes from flink_ml_tpu_torch.native.chunk_store):
//   dc_create(memory_budget, spill_dir) -> handle (NULL on failure)
//   dc_append(handle, data, nbytes)     -> chunk index, or -1 on failure
//   dc_num_chunks(handle)               -> count
//   dc_chunk_size(handle, idx)          -> bytes, or -1
//   dc_read(handle, idx, out)           -> 0 ok / -1 failure (copies chunk)
//   dc_memory_bytes(handle)             -> resident bytes
//   dc_spilled_chunks(handle)           -> how many chunks live on disk
//   dc_destroy(handle)                  -> frees memory and spill files
//
// Thread safety: a single mutex per cache (the workload is coarse-grained —
// chunks are megabytes, calls are few).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Chunk {
    size_t size = 0;
    std::vector<char> mem;   // resident payload (empty when spilled)
    std::string path;        // spill file (empty when resident)
};

struct DataCache {
    size_t memory_budget = 0;
    size_t memory_bytes = 0;
    std::string spill_dir;
    std::vector<Chunk> chunks;
    long spilled = 0;
    std::mutex mu;
};

bool write_file(const std::string& path, const void* data, size_t n) {
    std::FILE* f = std::fopen(path.c_str(), "wb");
    if (!f) return false;
    size_t written = std::fwrite(data, 1, n, f);
    std::fclose(f);
    return written == n;
}

bool read_file(const std::string& path, void* out, size_t n) {
    std::FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    size_t got = std::fread(out, 1, n, f);
    std::fclose(f);
    return got == n;
}

}  // namespace

extern "C" {

void* dc_create(size_t memory_budget, const char* spill_dir) {
    DataCache* dc = new (std::nothrow) DataCache();
    if (!dc) return nullptr;
    dc->memory_budget = memory_budget;
    dc->spill_dir = spill_dir ? spill_dir : "";
    return dc;
}

long dc_append(void* handle, const void* data, size_t nbytes) {
    DataCache* dc = static_cast<DataCache*>(handle);
    if (!dc || !data) return -1;
    std::lock_guard<std::mutex> lock(dc->mu);
    Chunk chunk;
    chunk.size = nbytes;
    bool spill = !dc->spill_dir.empty() &&
                 dc->memory_bytes + nbytes > dc->memory_budget;
    if (spill) {
        chunk.path = dc->spill_dir + "/chunk" +
                     std::to_string(dc->chunks.size()) + ".bin";
        if (!write_file(chunk.path, data, nbytes)) return -1;
        dc->spilled += 1;
    } else {
        chunk.mem.assign(static_cast<const char*>(data),
                         static_cast<const char*>(data) + nbytes);
        dc->memory_bytes += nbytes;
    }
    dc->chunks.push_back(std::move(chunk));
    return static_cast<long>(dc->chunks.size()) - 1;
}

long dc_num_chunks(void* handle) {
    DataCache* dc = static_cast<DataCache*>(handle);
    if (!dc) return -1;
    std::lock_guard<std::mutex> lock(dc->mu);
    return static_cast<long>(dc->chunks.size());
}

long dc_chunk_size(void* handle, long idx) {
    DataCache* dc = static_cast<DataCache*>(handle);
    if (!dc) return -1;
    std::lock_guard<std::mutex> lock(dc->mu);
    if (idx < 0 || idx >= static_cast<long>(dc->chunks.size())) return -1;
    return static_cast<long>(dc->chunks[idx].size);
}

int dc_read(void* handle, long idx, void* out) {
    DataCache* dc = static_cast<DataCache*>(handle);
    if (!dc || !out) return -1;
    std::lock_guard<std::mutex> lock(dc->mu);
    if (idx < 0 || idx >= static_cast<long>(dc->chunks.size())) return -1;
    const Chunk& chunk = dc->chunks[idx];
    if (!chunk.path.empty()) {
        return read_file(chunk.path, out, chunk.size) ? 0 : -1;
    }
    std::memcpy(out, chunk.mem.data(), chunk.size);
    return 0;
}

size_t dc_memory_bytes(void* handle) {
    DataCache* dc = static_cast<DataCache*>(handle);
    if (!dc) return 0;
    std::lock_guard<std::mutex> lock(dc->mu);
    return dc->memory_bytes;
}

long dc_spilled_chunks(void* handle) {
    DataCache* dc = static_cast<DataCache*>(handle);
    if (!dc) return -1;
    std::lock_guard<std::mutex> lock(dc->mu);
    return dc->spilled;
}

void dc_destroy(void* handle) {
    DataCache* dc = static_cast<DataCache*>(handle);
    if (!dc) return;
    {
        std::lock_guard<std::mutex> lock(dc->mu);
        for (const Chunk& chunk : dc->chunks) {
            if (!chunk.path.empty()) std::remove(chunk.path.c_str());
        }
    }
    delete dc;
}

}  // extern "C"
