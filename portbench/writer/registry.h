// The frozen writer's registries: each codec source registers its
// encoders, and the filter source its filters, by the configuration's
// names, while the library loads. writer.cc frames chunks from what
// they register, so adding a codec adds a source file and edits none.
#pragma once

#include <cstdint>

namespace pbw {

// Encode n bytes of src into at most maxout bytes of dst; returns the
// stream's size, 0 where it does not fit, or < 0 on an error.
using EncodeFn = int (*)(int clevel, const uint8_t* src, int n, uint8_t* dst,
                         int maxout);
// Filter n bytes of src into dst, with n bytes of scratch in tmp;
// returns false where the filter leaves this block as it is.
using FilterFn = bool (*)(int typesize, int64_t n, const uint8_t* src,
                          uint8_t* dst, uint8_t* tmp);

struct Codec {
  const char* name;  // the configuration's cname
  int compformat;    // the header's flags >> 5
  bool hcr;          // c-blosc's HCR codecs: twice the automatic blocksize
  bool split;        // split in c-blosc's forward-compatible split mode
  EncodeFn encode;
};

struct Filter {
  const char* name;  // the configuration's shuffle
  uint8_t flag;      // the header's flag bits
  FilterFn apply;    // nullptr: no filter
};

bool add_codec(const Codec& codec);
bool add_filter(const Filter& filter);
const Codec* find_codec(const char* name);
const Filter* find_filter(const char* name);

}  // namespace pbw
