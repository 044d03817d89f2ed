// femmesh: native mesh engine for fem_tpu.
//
// Plays the role of the reference's host-side native stack: the Fortran
// list-directed deck reader (m_io.F90:12-105,282-475), METIS partitioning
// (METIS_PartMeshNodal, m_io.F90:137), and the element-distribution /
// renumbering machinery (m_io.F90:145-237, main.F90:49-97). Re-designed for
// the JAX framework: instead of graph partitioning for MPI ranks, it
// provides
//   - a fast .inp deck parser producing flat arrays (the Python parser is
//     the fallback; this one handles multi-hundred-MB decks),
//   - Morton (Z-order) element ordering for gather locality,
//   - recursive coordinate bisection (RCB) partitioning for device sharding.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- tokenizer
struct Tokenizer {
  const char* p;
  const char* end;
  explicit Tokenizer(const char* text, size_t len) : p(text), end(text + len) {}

  // Advance past whitespace and !-comments (comment runs to end of line —
  // matching Fortran list-directed semantics where trailing tokens are
  // dropped; we drop them lazily because records consume fixed counts).
  void skip_ws() {
    while (p < end) {
      if (*p == '!') {
        while (p < end && *p != '\n') ++p;
      } else if (std::isspace(static_cast<unsigned char>(*p))) {
        ++p;
      } else {
        break;
      }
    }
  }

  bool next(std::string& tok) {
    skip_ws();
    if (p >= end) return false;
    const char* start = p;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p)) &&
           *p != '!')
      ++p;
    tok.assign(start, p - start);
    return true;
  }

  bool next_int(long& v) {
    std::string t;
    if (!next(t)) return false;
    v = std::strtol(t.c_str(), nullptr, 10);
    return true;
  }

  bool next_double(double& v) {
    std::string t;
    if (!next(t)) return false;
    // Fortran-style exponents (1.0D5) are normalized to E.
    for (auto& c : t)
      if (c == 'D' || c == 'd') c = 'e';
    v = std::strtod(t.c_str(), nullptr);
    return true;
  }

  // Skip the remainder of the current line (used after fixed-count records
  // to emulate the advancing list-directed READ).
  void skip_line() {
    while (p < end && *p != '\n') ++p;
  }
};

// element registry mirror (fem_tpu/ops/elements.py TYPE_ORDER)
struct ElType {
  const char* name;
  int nn;
};
const ElType kTypes[] = {{"tri", 3}, {"qua", 4}, {"tet", 4}, {"hex", 8},
                         {"coh", 4}};
const int kNumTypes = 5;
const int kMaxNodes = 8;

int type_code(const std::string& s) {
  for (int i = 0; i < kNumTypes; ++i)
    if (s == kTypes[i].name) return i;
  return -1;
}

}  // namespace

extern "C" {

// Flat parsed deck. All arrays are heap-allocated by the parser and released
// by fem_free_deck. Node/element ids are 0-based; conn is padded with -1.
struct FemDeck {
  int stype;  // 0 = implicit, 1 = explicit, 2 = other
  int pdim;
  int nodal_bw;
  double t, dt;
  int nels, nnds, nmts, ncohmats, nceqs, nfrcs, ntrcs, nbcs;
  int* elem_type;     // [nels]
  int* elem_conn;     // [nels * 8], -1 padded
  int* elem_mat;      // [nels], -1 if none
  int* elem_nlmat;    // [nels], -1 if none
  double* coords;     // [nnds * pdim]
  double* mats;       // [nmts * 5]
  int* coh_law;       // [ncohmats]
  double* coh_props;  // [ncohmats * 6]
  int* bc_node;       // [nbcs]
  int* bc_flags;      // [nbcs * pdim]
  double* bc_vals;    // [nbcs * pdim]
  int* f_node;        // [nfrcs]
  double* f_vec;      // [nfrcs * pdim]
  double* f_win;      // [nfrcs * 2] (t1, t2) clamped to <= t
  int* t_el;          // [ntrcs]
  int* t_side;        // [ntrcs] (1-based, as in the deck)
  double* t_vec;      // [ntrcs * pdim]
  double* t_win;      // [ntrcs * 2] raw values
  char error[256];
};

static int fail(FemDeck* d, const char* msg) {
  std::snprintf(d->error, sizeof(d->error), "%s", msg);
  return 1;
}

int fem_parse_deck(const char* text, int64_t len, FemDeck* d) {
  std::memset(d, 0, sizeof(FemDeck));
  Tokenizer tk(text, static_cast<size_t>(len));
  std::string tok;

  // header line 1: stype pdim nodal_bw
  if (!tk.next(tok)) return fail(d, "missing stype");
  d->stype = (tok == "implicit") ? 0 : (tok == "explicit" ? 1 : 2);
  long v;
  if (!tk.next_int(v)) return fail(d, "missing pdim");
  d->pdim = static_cast<int>(v);
  if (d->pdim != 2 && d->pdim != 3) return fail(d, "pdim must be 2 or 3");
  if (!tk.next_int(v)) return fail(d, "missing nodal_bw");
  d->nodal_bw = static_cast<int>(v);
  tk.skip_line();

  // header line 2: 8 canonical counts or legacy 7 (no ncohmats). Count the
  // integers on the line.
  long counts[9];
  int ncounts = 0;
  {
    // find the extent of this (non-empty) line after skipping blank lines
    tk.skip_ws();
    const char* ls = tk.p;
    const char* le = ls;
    while (le < tk.end && *le != '\n') ++le;
    Tokenizer lt(ls, static_cast<size_t>(le - ls));
    while (ncounts < 9 && lt.next_int(v)) counts[ncounts++] = v;
    tk.p = le;
  }
  if (ncounts >= 8) {
    d->nels = (int)counts[0]; d->nnds = (int)counts[1];
    d->nmts = (int)counts[2]; d->ncohmats = (int)counts[3];
    d->nceqs = (int)counts[4]; d->nfrcs = (int)counts[5];
    d->ntrcs = (int)counts[6]; d->nbcs = (int)counts[7];
  } else if (ncounts == 7) {
    d->nels = (int)counts[0]; d->nnds = (int)counts[1];
    d->nmts = (int)counts[2]; d->ncohmats = 0;
    d->nceqs = (int)counts[3]; d->nfrcs = (int)counts[4];
    d->ntrcs = (int)counts[5]; d->nbcs = (int)counts[6];
  } else {
    return fail(d, "expected 7 or 8 header counts");
  }
  if (d->nceqs) return fail(d, "constraint equations (nceqs>0) unsupported");

  // header line 3: t dt (trailing tokens ignored)
  if (!tk.next_double(d->t)) return fail(d, "missing t");
  if (!tk.next_double(d->dt)) return fail(d, "missing dt");
  tk.skip_line();

  const int pdim = d->pdim;
  d->elem_type = (int*)std::malloc(sizeof(int) * d->nels);
  d->elem_conn = (int*)std::malloc(sizeof(int) * d->nels * kMaxNodes);
  d->elem_mat = (int*)std::malloc(sizeof(int) * d->nels);
  d->elem_nlmat = (int*)std::malloc(sizeof(int) * d->nels);
  for (int e = 0; e < d->nels; ++e) {
    if (!tk.next(tok)) return fail(d, "unexpected EOF in elements");
    int tc = type_code(tok);
    if (tc < 0) return fail(d, "unknown element type");
    d->elem_type[e] = tc;
    int nn = kTypes[tc].nn;
    for (int i = 0; i < kMaxNodes; ++i) d->elem_conn[e * kMaxNodes + i] = -1;
    for (int i = 0; i < nn; ++i) {
      if (!tk.next_int(v)) return fail(d, "bad element connectivity");
      if (v < 1 || v > d->nnds) return fail(d, "node id out of range");
      d->elem_conn[e * kMaxNodes + i] = static_cast<int>(v - 1);
    }
    if (!tk.next_int(v)) return fail(d, "missing element material");
    d->elem_mat[e] = static_cast<int>(v - 1);
    // nlMat column is optional (legacy decks, SURVEY.md 2d.8): if the next
    // token on THIS line is an integer, take it.
    {
      const char* save = tk.p;
      // peek within the line
      const char* q = tk.p;
      bool has = false;
      while (q < tk.end && *q != '\n') {
        if (*q == '!') break;
        if (!std::isspace(static_cast<unsigned char>(*q))) { has = true; break; }
        ++q;
      }
      if (has && (std::isdigit(static_cast<unsigned char>(*q)) || *q == '-')) {
        if (tk.next_int(v)) d->elem_nlmat[e] = static_cast<int>(v - 1);
      } else {
        d->elem_nlmat[e] = -1;
        tk.p = save;
      }
    }
    tk.skip_line();
  }

  // Every fixed-count record below ends with skip_line(): the reference's
  // list-directed READ advances one record per statement (m_io.F90), so
  // trailing extra tokens on a line are ignored, not consumed as the next
  // record's values (ADVICE r1 — a pure token stream silently desyncs).
  d->coords = (double*)std::malloc(sizeof(double) * d->nnds * pdim);
  for (int i = 0; i < d->nnds; ++i) {
    for (int j = 0; j < pdim; ++j)
      if (!tk.next_double(d->coords[i * pdim + j]))
        return fail(d, "bad coordinates");
    tk.skip_line();
  }

  d->mats = (double*)std::malloc(sizeof(double) * d->nmts * 5);
  for (int i = 0; i < d->nmts; ++i) {
    for (int j = 0; j < 5; ++j)
      if (!tk.next_double(d->mats[i * 5 + j]))
        return fail(d, "bad materials");
    tk.skip_line();
  }

  d->coh_law = (int*)std::malloc(sizeof(int) * d->ncohmats);
  d->coh_props = (double*)std::malloc(sizeof(double) * d->ncohmats * 6);
  for (int i = 0; i < d->ncohmats; ++i) {
    if (!tk.next_int(v)) return fail(d, "bad cohesive material");
    if (v != 1) return fail(d, "unknown separation law");
    d->coh_law[i] = static_cast<int>(v);
    for (int j = 0; j < 6; ++j)
      if (!tk.next_double(d->coh_props[i * 6 + j]))
        return fail(d, "bad cohesive props");
    tk.skip_line();
  }

  d->bc_node = (int*)std::malloc(sizeof(int) * d->nbcs);
  d->bc_flags = (int*)std::malloc(sizeof(int) * d->nbcs * pdim);
  d->bc_vals = (double*)std::malloc(sizeof(double) * d->nbcs * pdim);
  for (int i = 0; i < d->nbcs; ++i) {
    if (!tk.next_int(v)) return fail(d, "bad bc node");
    d->bc_node[i] = static_cast<int>(v - 1);
    for (int j = 0; j < pdim; ++j) {
      if (!tk.next_int(v)) return fail(d, "bad bc flags");
      d->bc_flags[i * pdim + j] = static_cast<int>(v);
    }
    for (int j = 0; j < pdim; ++j)
      if (!tk.next_double(d->bc_vals[i * pdim + j]))
        return fail(d, "bad bc values");
    tk.skip_line();
  }

  d->f_node = (int*)std::malloc(sizeof(int) * d->nfrcs);
  d->f_vec = (double*)std::malloc(sizeof(double) * d->nfrcs * pdim);
  d->f_win = (double*)std::malloc(sizeof(double) * d->nfrcs * 2);
  for (int i = 0; i < d->nfrcs; ++i) {
    if (!tk.next_int(v)) return fail(d, "bad force node");
    d->f_node[i] = static_cast<int>(v - 1);
    for (int j = 0; j < pdim; ++j)
      if (!tk.next_double(d->f_vec[i * pdim + j])) return fail(d, "bad force");
    double t1, t2;
    if (!tk.next_double(t1) || !tk.next_double(t2))
      return fail(d, "bad force window");
    // window clamp to <= t (m_io.F90:357-358)
    d->f_win[i * 2] = std::min(t1, d->t);
    d->f_win[i * 2 + 1] = std::min(t2, d->t);
    tk.skip_line();
  }

  d->t_el = (int*)std::malloc(sizeof(int) * d->ntrcs);
  d->t_side = (int*)std::malloc(sizeof(int) * d->ntrcs);
  d->t_vec = (double*)std::malloc(sizeof(double) * d->ntrcs * pdim);
  d->t_win = (double*)std::malloc(sizeof(double) * d->ntrcs * 2);
  for (int i = 0; i < d->ntrcs; ++i) {
    if (!tk.next_int(v)) return fail(d, "bad traction element");
    d->t_el[i] = static_cast<int>(v - 1);
    if (!tk.next_int(v)) return fail(d, "bad traction side");
    d->t_side[i] = static_cast<int>(v);
    for (int j = 0; j < pdim; ++j)
      if (!tk.next_double(d->t_vec[i * pdim + j]))
        return fail(d, "bad traction");
    if (!tk.next_double(d->t_win[i * 2]) ||
        !tk.next_double(d->t_win[i * 2 + 1]))
      return fail(d, "bad traction window");
    tk.skip_line();
  }

  return 0;
}

int fem_parse_deck_file(const char* path, FemDeck* d) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) {
    std::memset(d, 0, sizeof(FemDeck));
    return fail(d, "cannot open file");
  }
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(len));
  size_t rd = std::fread(buf.data(), 1, static_cast<size_t>(len), f);
  std::fclose(f);
  return fem_parse_deck(buf.data(), static_cast<int64_t>(rd), d);
}

void fem_free_deck(FemDeck* d) {
  std::free(d->elem_type); std::free(d->elem_conn);
  std::free(d->elem_mat); std::free(d->elem_nlmat);
  std::free(d->coords); std::free(d->mats);
  std::free(d->coh_law); std::free(d->coh_props);
  std::free(d->bc_node); std::free(d->bc_flags); std::free(d->bc_vals);
  std::free(d->f_node); std::free(d->f_vec); std::free(d->f_win);
  std::free(d->t_el); std::free(d->t_side); std::free(d->t_vec);
  std::free(d->t_win);
  std::memset(d, 0, sizeof(FemDeck));
}

// ------------------------------------------------------------ Morton order
// Z-order curve index of element centroids: locality-preserving element
// reordering so that gathers of neighboring elements touch neighboring
// nodes (replaces METIS' fill-reducing/locality role for the device gather
// path).
static uint64_t spread3(uint64_t x) {
  x &= 0x1fffff;
  x = (x | x << 32) & 0x1f00000000ffffULL;
  x = (x | x << 16) & 0x1f0000ff0000ffULL;
  x = (x | x << 8) & 0x100f00f00f00f00fULL;
  x = (x | x << 4) & 0x10c30c30c30c30c3ULL;
  x = (x | x << 2) & 0x1249249249249249ULL;
  return x;
}

static uint64_t spread2(uint64_t x) {
  x &= 0xffffffff;
  x = (x | x << 16) & 0x0000ffff0000ffffULL;
  x = (x | x << 8) & 0x00ff00ff00ff00ffULL;
  x = (x | x << 4) & 0x0f0f0f0f0f0f0f0fULL;
  x = (x | x << 2) & 0x3333333333333333ULL;
  x = (x | x << 1) & 0x5555555555555555ULL;
  return x;
}

void fem_morton_order(const double* centroids, int64_t ne, int pdim,
                      int32_t* order_out) {
  if (ne == 0) return;
  std::vector<double> mins(pdim, 1e300), maxs(pdim, -1e300);
  for (int64_t e = 0; e < ne; ++e)
    for (int j = 0; j < pdim; ++j) {
      double c = centroids[e * pdim + j];
      mins[j] = std::min(mins[j], c);
      maxs[j] = std::max(maxs[j], c);
    }
  const uint64_t bits = (pdim == 3) ? 21 : 32;
  const double scale_max = static_cast<double>((1ULL << bits) - 1);
  std::vector<std::pair<uint64_t, int32_t>> keys(static_cast<size_t>(ne));
  for (int64_t e = 0; e < ne; ++e) {
    uint64_t key = 0;
    for (int j = 0; j < pdim; ++j) {
      double span = maxs[j] - mins[j];
      double t = span > 0 ? (centroids[e * pdim + j] - mins[j]) / span : 0.0;
      uint64_t q = static_cast<uint64_t>(t * scale_max);
      key |= (pdim == 3 ? spread3(q) << j : spread2(q) << j);
    }
    keys[static_cast<size_t>(e)] = {key, static_cast<int32_t>(e)};
  }
  std::sort(keys.begin(), keys.end());
  for (int64_t e = 0; e < ne; ++e)
    order_out[e] = keys[static_cast<size_t>(e)].second;
}

// --------------------------------------------------------- RCB partitioning
// Recursive coordinate bisection of element centroids into nparts equal
// parts (METIS_PartMeshNodal replacement for device sharding: equal counts
// matter — every device shard does identical dense work — and spatial
// compactness minimizes the shared-dof reduction surface).
static void rcb_recurse(const double* centroids, int pdim,
                        std::vector<int32_t>& ids, size_t lo, size_t hi,
                        int part_lo, int part_hi, int32_t* part_out) {
  int nparts = part_hi - part_lo;
  if (nparts <= 1) {
    for (size_t i = lo; i < hi; ++i) part_out[ids[i]] = part_lo;
    return;
  }
  // split axis: widest extent
  double mins[3] = {1e300, 1e300, 1e300}, maxs[3] = {-1e300, -1e300, -1e300};
  for (size_t i = lo; i < hi; ++i)
    for (int j = 0; j < pdim; ++j) {
      double c = centroids[static_cast<int64_t>(ids[i]) * pdim + j];
      mins[j] = std::min(mins[j], c);
      maxs[j] = std::max(maxs[j], c);
    }
  int axis = 0;
  double best = -1;
  for (int j = 0; j < pdim; ++j)
    if (maxs[j] - mins[j] > best) {
      best = maxs[j] - mins[j];
      axis = j;
    }
  int left_parts = nparts / 2;
  size_t mid = lo + (hi - lo) * static_cast<size_t>(left_parts) /
                        static_cast<size_t>(nparts);
  std::nth_element(
      ids.begin() + static_cast<std::ptrdiff_t>(lo),
      ids.begin() + static_cast<std::ptrdiff_t>(mid),
      ids.begin() + static_cast<std::ptrdiff_t>(hi),
      [&](int32_t a, int32_t b) {
        return centroids[static_cast<int64_t>(a) * pdim + axis] <
               centroids[static_cast<int64_t>(b) * pdim + axis];
      });
  rcb_recurse(centroids, pdim, ids, lo, mid, part_lo, part_lo + left_parts,
              part_out);
  rcb_recurse(centroids, pdim, ids, mid, hi, part_lo + left_parts, part_hi,
              part_out);
}

void fem_rcb_partition(const double* centroids, int64_t ne, int pdim,
                       int nparts, int32_t* part_out) {
  std::vector<int32_t> ids(static_cast<size_t>(ne));
  for (int64_t e = 0; e < ne; ++e) ids[static_cast<size_t>(e)] = (int32_t)e;
  rcb_recurse(centroids, pdim, ids, 0, static_cast<size_t>(ne), 0, nparts,
              part_out);
}

}  // extern "C"
