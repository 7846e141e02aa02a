// The kernels' binding to PyTorch: operators of the `urmap` namespace.
//
// Each operator checks its tensors (CUDA, dtype, rank, contiguous, shapes),
// allocates its outputs with at::empty, takes PyTorch's current stream and
// calls the plain C entry point of its kernel (csrc/*.cu, which include no
// torch header; the prototypes are csrc/urmap_kernels.h's). An entry point
// returns cudaGetLastError() after its launch; a non-zero code raises here,
// where the launch was refused. The operators are implemented for the CUDA
// key only: a CPU tensor has no kernel and the dispatcher raises. A value
// the kernels do not take (a dtype, a shape, a band half-width without a
// kernel) raises ValueError.
//
// No pybind, no Python.h: the library is loaded with torch.ops.load_library
// and the wrappers in kernels/*.py call torch.ops.urmap.<name>.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <tuple>

#include "urmap_kernels.h"

namespace {

using at::Tensor;

void require(const Tensor& t, const char* name, at::ScalarType dtype,
             int64_t ndim) {
  TORCH_CHECK_VALUE(t.is_cuda(), name, ": expected a CUDA tensor, got ",
                    t.device());
  TORCH_CHECK_VALUE(t.scalar_type() == dtype, name, ": expected ", dtype,
                    ", got ", t.scalar_type());
  TORCH_CHECK_VALUE(t.dim() == ndim, name, ": expected ", ndim, " dims, got ",
                    t.dim());
  TORCH_CHECK_VALUE(t.is_contiguous(), name,
                    ": expected a contiguous tensor");
}

void same_device(const Tensor& a, const Tensor& b, const char* name) {
  TORCH_CHECK_VALUE(a.device() == b.device(), name, ": on ", b.device(),
                    ", expected ", a.device());
}

void* stream_of(const Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void launched(int err, const char* name) {
  TORCH_CHECK(err == 0, name, ": CUDA error ", err, " at launch");
}

at::TensorOptions like(const Tensor& t, at::ScalarType dtype) {
  return t.options().dtype(dtype);
}

// a table of 32-bit words: the [R, 128] view of the row128 layout or 1-D
void require_table(const Tensor& table) {
  TORCH_CHECK_VALUE(
      table.dim() == 1 || (table.dim() == 2 && table.size(1) == 128),
      "table: expected 1-D or [R, 128], got ", table.sizes());
  require(table, "table", at::kInt, table.dim());
}

// starts of the fused fetches: int32 or int64, widened in the kernel
int require_starts(const Tensor& table, const Tensor& starts) {
  TORCH_CHECK_VALUE(
      starts.scalar_type() == at::kInt || starts.scalar_type() == at::kLong,
      "starts: expected int32 or int64, got ", starts.scalar_type());
  require(starts, "starts", starts.scalar_type(), 1);
  same_device(table, starts, "starts");
  return starts.scalar_type() == at::kLong ? 1 : 0;
}

void require_dp(const Tensor& windows, const Tensor& reads,
                const Tensor& lengths, int64_t hw, const char* name) {
  require(windows, "windows", at::kByte, 2);
  require(reads, "reads", at::kByte, 2);
  require(lengths, "lengths", at::kInt, 1);
  same_device(windows, reads, "reads");
  same_device(windows, lengths, "lengths");
  const int64_t n = reads.size(0), L = reads.size(1);
  TORCH_CHECK_VALUE(windows.size(0) == n && windows.size(1) == L + 2 * hw &&
                        lengths.size(0) == n,
                    name, ": windows ", windows.sizes(), ", reads ",
                    reads.sizes(), ", lengths ", lengths.sizes());
}

// The seed front: (rpacked2, rnplane2 int32[2B, nw], offs int32[2B, Q],
// valid bool[2B, Q], start int64[2B, Q], cnt int32[2B, Q]). `a`, `b`:
// the upload blocks (uint8) or the forward word planes (int32 [B, nw]).
// `obase` given: `offsets` is the packed row128 table. No `offsets`: the
// slots mode, start empty [0] and each seed's slot in place of cnt.
std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor, Tensor> seed_front(
    const Tensor& a, const Tensor& b, const Tensor& lengths, int64_t L,
    int64_t k, int64_t q, int64_t slot_bits,
    const std::optional<Tensor>& offsets, const std::optional<Tensor>& obase,
    int64_t cnt_bits, int64_t block_bits) {
  const bool upload = a.scalar_type() == at::kByte;
  const int64_t nw = (L + 15) / 16;
  require(a, "a", upload ? at::kByte : at::kInt, 2);
  require(b, "b", upload ? at::kByte : at::kInt, 2);
  require(lengths, "lengths", at::kInt, 1);
  same_device(a, b, "b");
  same_device(a, lengths, "lengths");
  const bool slots_mode = !offsets.has_value();
  if (!slots_mode) {
    require(*offsets, "offsets", at::kInt, 1);
    same_device(a, *offsets, "offsets");
  }
  const int64_t B = a.size(0);
  TORCH_CHECK_VALUE(L >= k && k >= 1 && k <= 32 && slot_bits >= 1 &&
                        slot_bits <= 31 && q >= 1,
                    "seed_front: unsupported L=", L, " k=", k, " q=", q,
                    " slot_bits=", slot_bits);
  TORCH_CHECK_VALUE(b.size(0) == B && lengths.size(0) == B &&
                        (upload || (a.size(1) == nw && b.size(1) == nw)),
                    "seed_front: a ", a.sizes(), ", b ", b.sizes(),
                    ", lengths ", lengths.sizes(), " (", nw, " words)");
  const int64_t slots = int64_t{1} << slot_bits;
  if (slots_mode) {
    TORCH_CHECK_VALUE(!obase.has_value(),
                      "seed_front: obase without offsets");
  } else if (obase.has_value()) {
    require(*obase, "obase", at::kInt, 1);
    same_device(a, *obase, "obase");
    TORCH_CHECK_VALUE(cnt_bits >= 1 && cnt_bits <= 16 && block_bits >= 0 &&
                          block_bits <= 31 &&
                          2 * offsets->size(0) >= slots &&
                          obase->size(0) >=
                              ((slots - 1) >> block_bits) + 1,
                      "seed_front: packed offsets ", offsets->sizes(),
                      ", obase ", obase->sizes(), " for 2^", slot_bits,
                      " slots (cnt_bits ", cnt_bits, ", block_bits ",
                      block_bits, ")");
  } else {
    TORCH_CHECK_VALUE(offsets->size(0) >= slots + 1, "seed_front: offsets ",
                      offsets->sizes(), " for 2^", slot_bits, " slots");
  }
  const c10::cuda::CUDAGuard guard(a.device());
  Tensor rp2 = at::empty({2 * B, nw}, like(a, at::kInt));
  Tensor rn2 = at::empty({2 * B, nw}, like(a, at::kInt));
  Tensor offs = at::empty({2 * B, q}, like(a, at::kInt));
  Tensor valid = at::empty({2 * B, q}, like(a, at::kBool));
  Tensor start = at::empty({slots_mode ? 0 : 2 * B, q}, like(a, at::kLong));
  Tensor cnt = at::empty({2 * B, q}, like(a, at::kInt));
  launched(urmap_seed_front(
               upload ? a.data_ptr() : nullptr,
               upload ? b.data_ptr() : nullptr, (int)a.size(1),
               (int)b.size(1), upload ? nullptr : a.data_ptr(),
               upload ? nullptr : b.data_ptr(), lengths.data_ptr(),
               slots_mode ? nullptr : offsets->data_ptr(),
               obase.has_value() ? obase->data_ptr() : nullptr,
               (int)cnt_bits, (int)block_bits, rp2.data_ptr(),
               rn2.data_ptr(), offs.data_ptr(), valid.data_ptr(),
               slots_mode ? nullptr : start.data_ptr(), cnt.data_ptr(),
               (int)B, (int)nw, (int)L, (int)k, (int)q, (int)slot_bits,
               stream_of(a)),
           "urmap_seed_front");
  return {rp2, rn2, offs, valid, start, cnt};
}

std::tuple<Tensor, Tensor> vote(const Tensor& cand, int64_t v) {
  require(cand, "cand", at::kInt, 2);
  const int64_t n = cand.size(0), m = cand.size(1);
  TORCH_CHECK_VALUE(m >= 1 && m <= 4096 && v >= 1 && v <= m,
                    "vote: unsupported M=", m, ", V=", v, " (M <= 4096)");
  const c10::cuda::CUDAGuard guard(cand.device());
  Tensor top = at::empty({n, v}, cand.options());
  Tensor votes = at::empty({n, v}, cand.options());
  launched(urmap_vote(cand.data_ptr(), top.data_ptr(), votes.data_ptr(),
                      (int)n, (int)m, (int)v, stream_of(cand)),
           "urmap_vote");
  return {top, votes};
}

std::tuple<Tensor, Tensor, Tensor, Tensor> banded_dp(
    const Tensor& windows, const Tensor& reads, const Tensor& lengths,
    int64_t hw, int64_t match, int64_t mismatch, int64_t gap_open,
    int64_t gap_extend, std::optional<int64_t> clip_open) {
  TORCH_CHECK_VALUE(hw >= 1 && hw <= 271, "banded_dp: no kernel for hw=",
                    hw, " (1 <= hw <= 271)");
  require_dp(windows, reads, lengths, hw, "banded_dp");
  const int64_t n = reads.size(0), L = reads.size(1);
  const c10::cuda::CUDAGuard guard(windows.device());
  const auto opts = like(windows, at::kInt);
  Tensor scores = at::empty({n}, opts), d0 = at::empty({n}, opts),
         d1 = at::empty({n}, opts), ung = at::empty({n}, opts);
  launched(urmap_banded_dp(windows.data_ptr(), reads.data_ptr(),
                           lengths.data_ptr(), scores.data_ptr(),
                           d0.data_ptr(), d1.data_ptr(), ung.data_ptr(),
                           (int)n, (int)L, (int)hw, (int)match, (int)mismatch,
                           (int)gap_open, (int)gap_extend,
                           clip_open.has_value() ? 1 : 0,
                           (int)clip_open.value_or(0), stream_of(windows)),
           "urmap_banded_dp");
  return {scores, d0, d1, ung};
}

std::tuple<Tensor, Tensor, Tensor, Tensor> banded_semiglobal(
    const Tensor& genome, const Tensor& cand_starts, const Tensor& reads,
    const Tensor& lengths, int64_t hw, int64_t match, int64_t mismatch,
    int64_t gap_open, int64_t gap_extend, std::optional<int64_t> clip_open) {
  TORCH_CHECK_VALUE(hw >= 1 && hw <= 271,
                    "banded_semiglobal: no kernel for hw=", hw,
                    " (1 <= hw <= 271)");
  require(genome, "genome", at::kByte, 1);
  require(cand_starts, "cand_starts", at::kInt, 1);
  require(reads, "reads", at::kByte, 2);
  require(lengths, "lengths", at::kInt, 1);
  same_device(genome, cand_starts, "cand_starts");
  same_device(genome, reads, "reads");
  same_device(genome, lengths, "lengths");
  const int64_t n = reads.size(0), L = reads.size(1);
  TORCH_CHECK_VALUE(cand_starts.size(0) == n && lengths.size(0) == n &&
                        genome.size(0) >= 1,
                    "banded_semiglobal: genome ", genome.sizes(), ", cand ",
                    cand_starts.sizes(), ", reads ", reads.sizes(),
                    ", lengths ", lengths.sizes());
  const c10::cuda::CUDAGuard guard(genome.device());
  const auto opts = like(genome, at::kInt);
  Tensor scores = at::empty({n}, opts), d0 = at::empty({n}, opts),
         ung = at::empty({n}, opts), span = at::empty({n}, opts);
  launched(urmap_banded_semiglobal(
               genome.data_ptr(), (long long)genome.size(0),
               cand_starts.data_ptr(), reads.data_ptr(), lengths.data_ptr(),
               scores.data_ptr(), d0.data_ptr(), ung.data_ptr(),
               span.data_ptr(), (int)n, (int)L, (int)hw, (int)match,
               (int)mismatch, (int)gap_open, (int)gap_extend,
               clip_open.has_value() ? 1 : 0, (int)clip_open.value_or(0),
               stream_of(genome)),
           "urmap_banded_semiglobal");
  return {scores, d0, ung, span};
}

// B6 → (score int32[N], dops int32[DWp, N], walk_ok bool[N]).
std::tuple<Tensor, Tensor, Tensor> tb_dops(
    const Tensor& windows, const Tensor& reads, const Tensor& lengths,
    int64_t hw, int64_t match, int64_t mismatch, int64_t gap_open,
    int64_t gap_extend) {
  TORCH_CHECK_VALUE(hw >= 1 && hw <= 31, "tb_dops: no kernel for hw=", hw,
                    ": a dops record holds the deletion run in 6 bits "
                    "(d <= 2 hw), so 1 <= hw <= 31");
  require_dp(windows, reads, lengths, hw, "tb_dops");
  const int64_t n = reads.size(0), L = reads.size(1);
  const int64_t dwp = ((L + 3) / 4 + 7) / 8 * 8;
  const c10::cuda::CUDAGuard guard(windows.device());
  Tensor score = at::empty({n}, like(windows, at::kInt));
  Tensor dops = at::empty({dwp, n}, like(windows, at::kInt));
  Tensor ok = at::empty({n}, like(windows, at::kBool));
  launched(urmap_tb_dops(windows.data_ptr(), reads.data_ptr(),
                         lengths.data_ptr(), score.data_ptr(), ok.data_ptr(),
                         dops.data_ptr(), (int)n, (int)L, (int)hw, (int)match,
                         (int)mismatch, (int)gap_open, (int)gap_extend,
                         stream_of(windows)),
           "urmap_tb_dops");
  return {score, dops, ok};
}

// B7 → (score int32[N], bend int32[N], bits int32[NWORDS, N]).
std::tuple<Tensor, Tensor, Tensor> tb_bits(
    const Tensor& windows, const Tensor& reads, const Tensor& lengths,
    int64_t hw, int64_t match, int64_t mismatch, int64_t gap_open,
    int64_t gap_extend) {
  TORCH_CHECK_VALUE(hw >= 1 && hw <= 271, "tb_bits: no kernel for hw=",
                    hw, " (1 <= hw <= 271)");
  require_dp(windows, reads, lengths, hw, "tb_bits");
  const int64_t n = reads.size(0), L = reads.size(1);
  const int64_t nwords = (L + 7) / 8 * ((2 * hw + 1 + 7) / 8 * 8);
  const c10::cuda::CUDAGuard guard(windows.device());
  Tensor score = at::empty({n}, like(windows, at::kInt));
  Tensor bend = at::empty({n}, like(windows, at::kInt));
  Tensor bits = at::empty({nwords, n}, like(windows, at::kInt));
  launched(urmap_tb_bits(windows.data_ptr(), reads.data_ptr(),
                         lengths.data_ptr(), score.data_ptr(),
                         bend.data_ptr(), bits.data_ptr(), (int)n, (int)L,
                         (int)hw, (int)match, (int)mismatch, (int)gap_open,
                         (int)gap_extend, stream_of(windows)),
           "urmap_tb_bits");
  return {score, bend, bits};
}

Tensor fetch(const Tensor& table, const Tensor& starts, int64_t width,
             int64_t row_words, bool window) {
  require_table(table);
  require(starts, "starts", at::kLong, 1);
  same_device(table, starts, "starts");
  const int64_t M = table.numel();
  TORCH_CHECK_VALUE(
      width >= 1 && row_words >= 1 && M >= (window ? width : row_words),
      "table of ", M, " words: width ", width, ", rows of ", row_words,
      " words");
  const int64_t n = starts.size(0);
  const c10::cuda::CUDAGuard guard(table.device());
  Tensor out = at::empty({n, width}, table.options());
  launched(urmap_row128_fetch(table.data_ptr(), (long long)M, (int)row_words,
                              starts.data_ptr(), out.data_ptr(), (long long)n,
                              (int)width, window ? 1 : 0, stream_of(table)),
           "urmap_row128_fetch");
  return out;
}

Tensor row128_fetch(const Tensor& table, const Tensor& starts, int64_t width,
                    int64_t row_words) {
  TORCH_CHECK_VALUE(table.dim() != 2 || row_words == table.size(1),
                    "table: rows of ", table.size(table.dim() - 1),
                    " words, row_words ", row_words);
  return fetch(table, starts, width, row_words, false);
}

Tensor row128_window_fetch(const Tensor& table, const Tensor& starts,
                           int64_t width) {
  return fetch(table, starts, width, 1, true);
}

Tensor rotate_narrow(const Tensor& rows, const Tensor& off, int64_t width) {
  require(rows, "rows", at::kInt, 2);
  require(off, "off", at::kInt, 1);
  same_device(rows, off, "off");
  const int64_t n = rows.size(0), W = rows.size(1);
  TORCH_CHECK_VALUE(off.size(0) == n && width >= 1 && width <= W,
                    "rotate_narrow: rows ", rows.sizes(), ", off ",
                    off.sizes(), ", width ", width);
  const c10::cuda::CUDAGuard guard(rows.device());
  Tensor out = at::empty({n, width}, rows.options());
  launched(urmap_rotate_narrow(rows.data_ptr(), off.data_ptr(),
                               out.data_ptr(), (long long)n, (int)W,
                               (int)width, stream_of(rows)),
           "urmap_rotate_narrow");
  return out;
}

Tensor window_codes(const Tensor& ginter, int64_t base_off,
                    const Tensor& starts, int64_t length) {
  require_table(ginter);
  const int starts64 = require_starts(ginter, starts);
  const int64_t M = ginter.numel();
  const int64_t width = 2 * ((length + 15) / 16 + 1);
  TORCH_CHECK_VALUE(length >= 1 && M >= width, "table of ", M,
                    " words: a window of ", length, " bases takes ", width);
  const int64_t n = starts.size(0);
  const c10::cuda::CUDAGuard guard(ginter.device());
  Tensor out = at::empty({n, length}, like(ginter, at::kByte));
  launched(urmap_window_codes(ginter.data_ptr(), (long long)M,
                              (long long)base_off, starts.data_ptr(),
                              starts64, out.data_ptr(), (long long)n,
                              (int)length, stream_of(ginter)),
           "urmap_window_codes");
  return out;
}

Tensor window_mismatches(const Tensor& ginter, int64_t base_off,
                         const Tensor& starts, const Tensor& rpacked,
                         const Tensor& rnplane, const Tensor& lengths) {
  require_table(ginter);
  const int starts64 = require_starts(ginter, starts);
  require(rpacked, "rpacked", at::kInt, 2);
  require(rnplane, "rnplane", at::kInt, 2);
  require(lengths, "lengths", at::kInt, 1);
  same_device(ginter, rpacked, "rpacked");
  same_device(ginter, rnplane, "rnplane");
  same_device(ginter, lengths, "lengths");
  const int64_t n = starts.size(0), nw = rpacked.size(1);
  const int64_t M = ginter.numel();
  TORCH_CHECK_VALUE(nw >= 1 && M >= 2 * (nw + 1), "table of ", M,
                    " words: a window of ", nw, " read words takes ",
                    2 * (nw + 1));
  TORCH_CHECK_VALUE(rpacked.size(0) == n && rnplane.sizes() == rpacked.sizes()
                        && lengths.size(0) == n,
                    "window_mismatches: starts ", starts.sizes(),
                    ", rpacked ", rpacked.sizes(), ", rnplane ",
                    rnplane.sizes(), ", lengths ", lengths.sizes());
  const c10::cuda::CUDAGuard guard(ginter.device());
  Tensor out = at::empty({n}, like(ginter, at::kInt));
  launched(urmap_window_mismatches(
               ginter.data_ptr(), (long long)M, (long long)base_off,
               starts.data_ptr(), starts64, rpacked.data_ptr(),
               rnplane.data_ptr(), lengths.data_ptr(), out.data_ptr(),
               (long long)n, (int)nw, stream_of(ginter)),
           "urmap_window_mismatches");
  return out;
}

// B8 → int32 [N, W]: `passes` rounds of the micro-benchmark's mix on every
// word (uint32 bits in int32).
Tensor micro_passes(const Tensor& x, int64_t passes) {
  require(x, "x", at::kInt, 2);
  TORCH_CHECK_VALUE(passes >= 0 && passes <= INT32_MAX,
                    "micro_passes: passes ", passes, " out of [0, 2^31)");
  const c10::cuda::CUDAGuard guard(x.device());
  Tensor out = at::empty(x.sizes(), x.options());
  launched(urmap_micro_passes(x.data_ptr(), out.data_ptr(),
                              (long long)x.numel(), (int)passes,
                              stream_of(x)),
           "urmap_micro_passes");
  return out;
}

}  // namespace

TORCH_LIBRARY(urmap, m) {
  m.def("seed_front(Tensor a, Tensor b, Tensor lengths, int L, int k, "
        "int q, int slot_bits, Tensor? offsets, Tensor? obase, int cnt_bits, "
        "int block_bits) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("vote(Tensor cand, int v) -> (Tensor, Tensor)");
  m.def("banded_dp(Tensor windows, Tensor reads, Tensor lengths, int hw, "
        "int match, int mismatch, int gap_open, int gap_extend, "
        "int? clip_open) -> (Tensor, Tensor, Tensor, Tensor)");
  m.def("banded_semiglobal(Tensor genome, Tensor cand_starts, Tensor reads, "
        "Tensor lengths, int hw, int match, int mismatch, int gap_open, "
        "int gap_extend, int? clip_open) -> (Tensor, Tensor, Tensor, Tensor)");
  m.def("tb_dops(Tensor windows, Tensor reads, Tensor lengths, int hw, "
        "int match, int mismatch, int gap_open, int gap_extend) "
        "-> (Tensor, Tensor, Tensor)");
  m.def("tb_bits(Tensor windows, Tensor reads, Tensor lengths, int hw, "
        "int match, int mismatch, int gap_open, int gap_extend) "
        "-> (Tensor, Tensor, Tensor)");
  m.def("row128_fetch(Tensor table, Tensor starts, int width, int row_words) "
        "-> Tensor");
  m.def("row128_window_fetch(Tensor table, Tensor starts, int width) "
        "-> Tensor");
  m.def("rotate_narrow(Tensor rows, Tensor off, int width) -> Tensor");
  m.def("window_codes(Tensor ginter, int base_off, Tensor starts, "
        "int length) -> Tensor");
  m.def("window_mismatches(Tensor ginter, int base_off, Tensor starts, "
        "Tensor rpacked, Tensor rnplane, Tensor lengths) -> Tensor");
  m.def("micro_passes(Tensor x, int passes) -> Tensor");
}

TORCH_LIBRARY_IMPL(urmap, CUDA, m) {
  m.impl("seed_front", &seed_front);
  m.impl("vote", &vote);
  m.impl("banded_dp", &banded_dp);
  m.impl("banded_semiglobal", &banded_semiglobal);
  m.impl("tb_dops", &tb_dops);
  m.impl("tb_bits", &tb_bits);
  m.impl("row128_fetch", &row128_fetch);
  m.impl("row128_window_fetch", &row128_window_fetch);
  m.impl("rotate_narrow", &rotate_narrow);
  m.impl("window_codes", &window_codes);
  m.impl("window_mismatches", &window_mismatches);
  m.impl("micro_passes", &micro_passes);
}
