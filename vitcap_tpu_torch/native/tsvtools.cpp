// Native TSV line-index scanner.
//
// Scans a TSV once with 8MB buffered reads + memchr and writes the
// `.lineidx.8b` sidecar (little-endian u64 byte offsets, the format the
// reference reads at tsv_io.py:267-286) via a per-process tmp + rename so
// concurrent processes don't race.  Python's per-line loop takes minutes on
// multi-GB caption/image TSVs; this runs at disk speed.
//
// Exposed via ctypes (vitcap_tpu_torch/data/native_tsv.py); built with
// g++ -O3 -shared by vitcap_tpu_torch/native/__init__.py at first use.

#include <cstdio>
#include <cstring>
#include <cstdint>
#include <string>
#include <vector>
#include <unistd.h>

extern "C" {

// Returns the number of lines indexed, or -1 on error.
long long build_lineidx_8b(const char* tsv_path, const char* out_path) {
    FILE* in = std::fopen(tsv_path, "rb");
    if (!in) return -1;

    // unique per-process tmp so concurrent writers never share an inode;
    // whichever rename lands last wins with a complete file either way
    std::string tmp = std::string(out_path) + ".tmp."
        + std::to_string(static_cast<long>(::getpid()));
    FILE* out = std::fopen(tmp.c_str(), "wb");
    if (!out) { std::fclose(in); return -1; }

    const size_t BUF = 8u << 20;
    std::vector<char> buf(BUF);
    std::vector<uint64_t> offs;
    offs.reserve(1u << 16);

    uint64_t pos = 0;            // absolute offset of the next byte to read
    bool at_line_start = true;   // next byte begins a line
    long long n_lines = 0;
    bool ok = true;

    while (true) {
        size_t got = std::fread(buf.data(), 1, BUF, in);
        if (got == 0) break;
        size_t i = 0;
        while (i < got) {
            if (at_line_start) {
                offs.push_back(pos + i);
                ++n_lines;
                at_line_start = false;
            }
            const char* nl = static_cast<const char*>(
                std::memchr(buf.data() + i, '\n', got - i));
            if (!nl) break;
            i = static_cast<size_t>(nl - buf.data()) + 1;
            at_line_start = true;
        }
        pos += got;
        if (offs.size() >= (1u << 20)) {   // flush in 8MB chunks
            if (std::fwrite(offs.data(), sizeof(uint64_t), offs.size(), out)
                    != offs.size()) { ok = false; break; }
            offs.clear();
        }
        if (got < BUF) break;
    }
    if (ok && !offs.empty()) {
        if (std::fwrite(offs.data(), sizeof(uint64_t), offs.size(), out)
                != offs.size()) ok = false;
    }
    std::fclose(in);
    if (std::fclose(out) != 0) ok = false;
    if (!ok || std::rename(tmp.c_str(), out_path) != 0) {
        std::remove(tmp.c_str());
        return -1;
    }
    return n_lines;
}

}  // extern "C"
