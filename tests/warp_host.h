// Warps as the card runs them, for the host builds of the kernels whose
// lanes exchange values (tests/g1_host.cpp: the Horner combine;
// tests/scan_host.cpp: the scans' look-back).  Each lane is a fiber
// (ucontext) on this thread, and the fibers run in turn, each until its
// next exchange or wait.  warp_shfl and warp_ballot (declared in
// csrc/field.cuh) deposit the lane's value in its warp's mailbox (two, used
// in turns, so a fast lane's next deposit never overwrites a value a slow
// lane has still to read) and yield until all 32 lanes of the warp have
// deposited; then the lane reads lane src's deposit, or every lane's for the
// ballot.  warp_wait yields too, for a lane that spins on memory another
// warp will write: several warps run at once, so one warp's lanes can wait
// for another's stores as on the card.  When three passes over the fibers
// in a row make no deposit and end no fiber, the waits are stuck: warp_wait
// returns false from then on (its caller records the fault), and if
// three more passes make no progress the run ends with -1.  Every lane of a
// warp must make as many exchanges: the run returns -1 if they do not.
// Included by one source of each host build.  Not part of the port.
#pragma once

#include <ucontext.h>

#include <cstdint>
#include <functional>
#include <memory>
#include <vector>

namespace {

struct Warps {
  static constexpr size_t STACK = 256 << 10;
  const uint32_t count;  // warps
  std::vector<ucontext_t> ctx;
  std::unique_ptr<char[]> stacks;  // left untouched until a lane runs on it
  std::vector<uint32_t> box;       // [warp][turn][lane]
  std::vector<std::vector<uint32_t>> arrivals;  // [warp][exchange]: lanes that deposited
  std::vector<uint32_t> exchanges;              // [fiber]
  std::vector<bool> done;
  ucontext_t sched;
  uint32_t current = 0;
  bool progress = false, stuck = false;
  std::function<void(uint32_t, uint32_t)> body;

  explicit Warps(uint32_t n)
      : count(n), ctx(32 * n), stacks(new char[32 * n * STACK]), box(2 * 32 * n), arrivals(n), exchanges(32 * n),
        done(32 * n) {}

  int run() {
    for (uint32_t f = 0; f < 32 * count; ++f) {
      getcontext(&ctx[f]);
      ctx[f].uc_stack.ss_sp = stacks.get() + f * STACK;
      ctx[f].uc_stack.ss_size = STACK;
      ctx[f].uc_link = &sched;
      makecontext(&ctx[f], fiber_main, 0);
    }
    for (int idle = 0;;) {
      bool any = false;
      progress = false;
      for (uint32_t f = 0; f < 32 * count; ++f)
        if (!done[f]) {
          current = f;
          swapcontext(&sched, &ctx[f]);
          any = true;
        }
      if (!any) break;
      idle = progress ? 0 : idle + 1;
      if (idle == 3) {
        if (stuck) return -1;  // the fibers are left unfinished
        stuck = true;
        idle = 0;
      }
    }
    for (uint32_t f = 0; f < 32 * count; ++f)
      if (exchanges[f] != exchanges[f & ~31u]) return -1;
    return 0;
  }

  void yield() { swapcontext(&ctx[current], &sched); }

  // Deposits v for the current lane, yields until every lane of its warp
  // has deposited, and returns the warp's mailbox of that exchange.
  const uint32_t* exchange(uint32_t v) {
    const uint32_t f = current, w = f / 32, k = exchanges[f]++;
    std::vector<uint32_t>& arrived = arrivals[w];
    if (arrived.size() <= k) arrived.resize(k + 1);
    uint32_t* mail = &box[(2 * w + (k & 1)) * 32];
    mail[f % 32] = v;
    ++arrived[k];
    progress = true;
    do yield();
    while (arrived[k] < 32);
    return mail;
  }

  static void fiber_main();
};

thread_local Warps* the_warps = nullptr;

void Warps::fiber_main() {
  Warps& w = *the_warps;
  const uint32_t f = w.current;
  w.body(f / 32, f % 32);
  w.done[f] = true;
  w.progress = true;
}

// Runs body(warp, lane) for the 32 lanes of `count` warps at once.
int run_warps(uint32_t count, std::function<void(uint32_t, uint32_t)> body) {
  Warps w(count);
  w.body = std::move(body);
  Warps* outer = the_warps;
  the_warps = &w;
  const int rc = w.run();
  the_warps = outer;
  return rc;
}

// Runs body(lane) for the 32 lanes of one warp.
int run_warp(std::function<void(uint32_t)> body) {
  return run_warps(1, [&](uint32_t, uint32_t lane) { body(lane); });
}

}  // namespace

uint32_t warp_shfl(uint32_t v, uint32_t src) { return the_warps->exchange(v)[src & 31]; }

uint32_t warp_ballot(bool pred) {
  const uint32_t* box = the_warps->exchange(pred);
  uint32_t mask = 0;
  for (int l = 0; l < 32; ++l) mask |= (box[l] ? 1u : 0u) << l;
  return mask;
}

// A lane waiting for another warp's store: yields, or returns false once
// the run is stuck.
inline bool warp_wait() {
  if (the_warps->stuck) return false;
  the_warps->yield();
  return true;
}
