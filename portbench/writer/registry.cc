// The registries of registry.h, and their names for the Python side.

#include "registry.h"

#include <cstring>
#include <string>
#include <vector>

namespace pbw {
namespace {

// function-local statics: built before the first registration, whatever
// the order in which the sources' static initializers run
std::vector<Codec>& codecs() {
  static std::vector<Codec> all;
  return all;
}

std::vector<Filter>& filters() {
  static std::vector<Filter> all;
  return all;
}

template <typename T>
const T* find(const std::vector<T>& all, const char* name) {
  for (const T& e : all)
    if (std::strcmp(e.name, name) == 0) return &e;
  return nullptr;
}

template <typename T>
const char* names(const std::vector<T>& all, std::string& out) {
  out.clear();
  for (const T& e : all) {
    if (!out.empty()) out += ',';
    out += e.name;
  }
  return out.c_str();
}

}  // namespace

bool add_codec(const Codec& codec) {
  codecs().push_back(codec);
  return true;
}

bool add_filter(const Filter& filter) {
  filters().push_back(filter);
  return true;
}

const Codec* find_codec(const char* name) { return find(codecs(), name); }

const Filter* find_filter(const char* name) { return find(filters(), name); }

}  // namespace pbw

extern "C" {

// The registered names, comma-separated, in registration order.
const char* pbw_codec_names() {
  static std::string out;
  return pbw::names(pbw::codecs(), out);
}

const char* pbw_filter_names() {
  static std::string out;
  return pbw::names(pbw::filters(), out);
}

}  // extern "C"
