// Hopper (sm_90a) kernels of the device telemetry (ROADMAP Queue 1 item 6):
// one launch per round records the round's sample into a telemetry plane
// (repro_torch/obs/telemetry.py), after the round's last kernel, with no
// host read.  The reference records with jnp ops inside its while_loop
// body (src/repro/obs/telemetry.py:93, called at
// src/repro/kernels/ops.py:1302 and src/repro/core/propagator.py:309,
// :408); it has no Pallas kernel.
//
//   record_round[_f32]        one instance's fixed point, reading the loop
//                             carry (core/carry.py): float64 and float32
//                             bounds, the ring in the bounds' dtype
//   record_round_batch[_f32]  one round of a batched fixed point over
//                             (B, n) planes
//
// record_round: a grid over the n columns.  Where the carry's ROUNDS has
// not passed unroll * ticks (a check group enqueued after GO cleared: the
// merge counted nothing) every block returns before reading a column:
// nothing is recorded.  Otherwise each thread tests its columns for
// lb > ub + feas_eps (in T, padding included, as the reference's
// jnp.any(nlb > nub + feas_eps)), each block ORs its threads' hits into
// scratch[1] and takes a ticket (scratch[0]) after a fence; the last block
// (StopCarryFlags::finish_progress's pattern, round_common.cuh) writes the
// carry's PROG to ring[ticks % cap], counts ticks, latches infeas_round at
// ROUNDS on a hit and, with an early stop armed (patience > 0),
// stop_round at ROUNDS where FLAT >= patience, and resets the scratch.
// With cap == 0 (the host loop, no plane) it records nothing: the last
// block writes the probe into the carry's CROSS field, which the host reads
// with the rest of the carry.
//
// record_round_batch: a (column block, row) grid; the rows that did not
// run this round (ran[row] == false) read nothing but take their ticket.
// The last block records each row that ran, as
// obs.telemetry.record_round(..., active=ran) does: prog[row] (the row's
// measure, written by #9's or #15's row form) to its ring, ticks counted,
// infeas_round and stop_round latched at rounds[row] (stop_round where
// flat[row] >= patience, patience > 0), and resets the scratch (a ticket
// and one hit flag per row).
//
// Bound on the H100: the two bound planes read once (2 * n * sizeof(T) per
// recorded row) plus the carry or the (B,) lanes; launch latency dominates.
//
// Build with --fmad=false (kernels/_build.py).  Every entry point returns
// cudaGetLastError() after its launch.

#include "record_round.cuh"

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int record_round(const double* lb, const double* ub, int* carry, double* ring, int* ticks,
                 int* stop_round, int* infeas_round, int* scratch, int64_t n, int cap,
                 int unroll, int patience, double feas_eps, cudaStream_t stream) {
  return launch_record_round(lb, ub, carry, ring, ticks, stop_round, infeas_round, scratch, n,
                             cap, unroll, patience, feas_eps, stream);
}

int record_round_f32(const float* lb, const float* ub, int* carry, float* ring, int* ticks,
                     int* stop_round, int* infeas_round, int* scratch, int64_t n, int cap,
                     int unroll, int patience, float feas_eps, cudaStream_t stream) {
  return launch_record_round(lb, ub, carry, ring, ticks, stop_round, infeas_round, scratch, n,
                             cap, unroll, patience, feas_eps, stream);
}

int record_round_batch(const double* lb, const double* ub, const double* prog, const bool* ran,
                       const int* rounds, const int* flat, double* ring, int* ticks,
                       int* stop_round, int* infeas_round, int* scratch, int64_t bsz,
                       int64_t n, int cap, int patience, double feas_eps, cudaStream_t stream) {
  return launch_record_round_batch(lb, ub, prog, ran, rounds, flat, ring, ticks, stop_round,
                                   infeas_round, scratch, bsz, n, cap, patience, feas_eps,
                                   stream);
}

int record_round_batch_f32(const float* lb, const float* ub, const float* prog, const bool* ran,
                           const int* rounds, const int* flat, float* ring, int* ticks,
                           int* stop_round, int* infeas_round, int* scratch, int64_t bsz,
                           int64_t n, int cap, int patience, float feas_eps,
                           cudaStream_t stream) {
  return launch_record_round_batch(lb, ub, prog, ran, rounds, flat, ring, ticks, stop_round,
                                   infeas_round, scratch, bsz, n, cap, patience, feas_eps,
                                   stream);
}

}  // extern "C"
