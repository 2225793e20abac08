// Native host runtime: N-way approximate-time synchronizer + latest-wins
// frame slot.
//
// TPU-native equivalent of the reference's header-only C++ sync layer
// (skeleton_3d/include/my_message_filters/sync_policies/approximate_time_vec.h
// and synchronizer_vec.h) and its producer/consumer worker handoff
// (skeleton_3d_triang_mult_node.cpp:66-69,999-1006). The synchronization
// algorithm is the classic ROS ApproximateTime optimal-candidate search
// (pivot selection, age penalty, inter-message lower-bound virtual moves),
// re-implemented from scratch against the algorithm's published semantics:
// payloads are opaque uint64 handles (indices into host arrays feeding the
// device), timestamps are int64 nanoseconds, and synchronized sets land in a
// ready queue the Python layer drains without holding the ingest lock.
//
// Build: `make` in this directory (g++ -O2 -shared). Python binding via
// ctypes in smartedgesensor3dhumanpose_tpu/sync.py.

#include <cstdint>
#include <deque>
#include <limits>
#include <mutex>
#include <vector>

namespace {

constexpr int64_t kNoLimit = std::numeric_limits<int64_t>::max();

struct Msg {
  int64_t stamp;
  uint64_t handle;
};

class ApproxTimeSync {
 public:
  ApproxTimeSync(uint32_t num_streams, uint32_t queue_size, double age_penalty,
                 int64_t max_interval_ns)
      : n_(num_streams),
        queue_size_(queue_size),
        age_penalty_(age_penalty),
        max_interval_(max_interval_ns <= 0 ? kNoLimit : max_interval_ns),
        deques_(num_streams),
        past_(num_streams),
        candidate_(num_streams),
        has_dropped_(num_streams, false),
        lower_bound_(num_streams, 0) {}

  void set_lower_bound(uint32_t i, int64_t ns) {
    if (i < n_) lower_bound_[i] = ns;
  }

  // Returns the number of synchronized sets ready after this push.
  uint32_t push(uint32_t i, int64_t stamp, uint64_t handle) {
    std::lock_guard<std::mutex> lock(mu_);
    if (i >= n_) return ready_.size();
    deques_[i].push_back(Msg{stamp, handle});
    if (deques_[i].size() == 1) {
      if (all_nonempty()) process();
    }
    if (deques_[i].size() + past_[i].size() > queue_size_) {
      // Queue overflow: recover the hidden messages, drop the oldest on the
      // offending stream, and invalidate any in-flight candidate.
      for (uint32_t j = 0; j < n_; ++j) recover_all(j);
      if (!deques_[i].empty()) deques_[i].pop_front();
      has_dropped_[i] = true;
      if (have_pivot_) {
        have_pivot_ = false;
        process();
      }
    }
    return static_cast<uint32_t>(ready_.size());
  }

  // Pops the oldest ready set; returns 1 on success.
  int pop(int64_t* stamps_out, uint64_t* handles_out) {
    std::lock_guard<std::mutex> lock(mu_);
    if (ready_.empty()) return 0;
    const std::vector<Msg>& set = ready_.front();
    for (uint32_t i = 0; i < n_; ++i) {
      stamps_out[i] = set[i].stamp;
      handles_out[i] = set[i].handle;
    }
    ready_.pop_front();
    return 1;
  }

  uint32_t ready_count() {
    std::lock_guard<std::mutex> lock(mu_);
    return static_cast<uint32_t>(ready_.size());
  }

 private:
  bool all_nonempty() const {
    for (const auto& d : deques_)
      if (d.empty()) return false;
    return true;
  }

  void boundary(uint32_t* index, int64_t* time, bool latest) const {
    *time = deques_[0].front().stamp;
    *index = 0;
    for (uint32_t i = 1; i < n_; ++i) {
      int64_t t = deques_[i].front().stamp;
      if ((t < *time) != latest) {
        *time = t;
        *index = i;
      }
    }
  }

  int64_t virtual_time(uint32_t i) const {
    if (!deques_[i].empty()) return deques_[i].front().stamp;
    // Empty: the earliest a future message could arrive given the
    // inter-message lower bound, never before the pivot.
    int64_t lb = past_[i].back().stamp + lower_bound_[i];
    return lb > pivot_time_ ? lb : pivot_time_;
  }

  void virtual_boundary(uint32_t* index, int64_t* time, bool latest) const {
    *time = virtual_time(0);
    *index = 0;
    for (uint32_t i = 1; i < n_; ++i) {
      int64_t t = virtual_time(i);
      if ((t < *time) != latest) {
        *time = t;
        *index = i;
      }
    }
  }

  void move_front_to_past(uint32_t i) {
    past_[i].push_back(deques_[i].front());
    deques_[i].pop_front();
  }

  void recover_all(uint32_t i) {
    while (!past_[i].empty()) {
      deques_[i].push_front(past_[i].back());
      past_[i].pop_back();
    }
  }

  void recover_n(uint32_t i, size_t k) {
    while (k-- > 0) {
      deques_[i].push_front(past_[i].back());
      past_[i].pop_back();
    }
  }

  void make_candidate() {
    for (uint32_t i = 0; i < n_; ++i) {
      candidate_[i] = deques_[i].front();
      past_[i].clear();
    }
  }

  void publish_candidate() {
    ready_.push_back(candidate_);
    have_pivot_ = false;
    // Recover hidden messages and consume the candidate heads.
    for (uint32_t i = 0; i < n_; ++i) {
      recover_all(i);
      deques_[i].pop_front();
    }
  }

  void process() {
    while (all_nonempty()) {
      uint32_t start_index, end_index;
      int64_t start_time, end_time;
      boundary(&end_index, &end_time, /*latest=*/true);
      boundary(&start_index, &start_time, /*latest=*/false);
      for (uint32_t i = 0; i < n_; ++i) {
        if (i != end_index) has_dropped_[i] = false;
      }
      if (!have_pivot_) {
        if (end_time - start_time > max_interval_) {
          // Interval too wide to ever be a candidate.
          deques_[start_index].pop_front();
          continue;
        }
        if (has_dropped_[end_index]) {
          // A stream that lost messages cannot be trusted as pivot.
          deques_[start_index].pop_front();
          continue;
        }
        make_candidate();
        candidate_start_ = start_time;
        candidate_end_ = end_time;
        pivot_ = end_index;
        pivot_time_ = end_time;
        have_pivot_ = true;
        move_front_to_past(start_index);
      } else {
        // Keep the candidate minimizing the age-penalized interval.
        double growth = static_cast<double>(end_time - candidate_end_) *
                        (1.0 + age_penalty_);
        if (growth >= static_cast<double>(start_time - candidate_start_)) {
          move_front_to_past(start_index);
        } else {
          make_candidate();
          candidate_start_ = start_time;
          candidate_end_ = end_time;
          move_front_to_past(start_index);
        }
      }
      // Optimality checks for the current pivot.
      if (start_index == pivot_) {
        publish_candidate();
      } else if (static_cast<double>(end_time - candidate_end_) *
                     (1.0 + age_penalty_) >=
                 static_cast<double>(pivot_time_ - candidate_start_)) {
        publish_candidate();
      } else if (!all_nonempty()) {
        // Virtual-move search: use the inter-message lower bounds to prove
        // (or fail to prove) that the candidate is optimal.
        std::vector<size_t> virtual_moves(n_, 0);
        while (true) {
          uint32_t vs_index, ve_index;
          int64_t vs_time, ve_time;
          virtual_boundary(&ve_index, &ve_time, true);
          virtual_boundary(&vs_index, &vs_time, false);
          double vgrowth = static_cast<double>(ve_time - candidate_end_) *
                           (1.0 + age_penalty_);
          if (vgrowth >= static_cast<double>(pivot_time_ - candidate_start_)) {
            publish_candidate();  // also undoes the virtual moves
            break;
          }
          if (vgrowth < static_cast<double>(vs_time - candidate_start_)) {
            // Cannot prove optimality; undo virtual moves and wait for data.
            for (uint32_t i = 0; i < n_; ++i) recover_n(i, virtual_moves[i]);
            break;
          }
          move_front_to_past(vs_index);
          ++virtual_moves[vs_index];
        }
      }
    }
  }

  const uint32_t n_;
  const uint32_t queue_size_;
  const double age_penalty_;
  const int64_t max_interval_;

  std::mutex mu_;
  std::vector<std::deque<Msg>> deques_;
  std::vector<std::vector<Msg>> past_;
  std::vector<Msg> candidate_;
  int64_t candidate_start_ = 0;
  int64_t candidate_end_ = 0;
  int64_t pivot_time_ = 0;
  uint32_t pivot_ = 0;
  bool have_pivot_ = false;
  std::vector<bool> has_dropped_;
  std::vector<int64_t> lower_bound_;
  std::deque<std::vector<Msg>> ready_;
};

// Latest-wins frame slot: the reference's mutex+condvar worker handoff
// (skeleton_3d_triang_mult_node.cpp:999-1006,1017-1025) minus the condvar
// (the Python side polls / blocks as it likes).
class LatestSlot {
 public:
  explicit LatestSlot(uint32_t n) : n_(n), stamps_(n), handles_(n) {}

  void put(const int64_t* stamps, const uint64_t* handles) {
    std::lock_guard<std::mutex> lock(mu_);
    if (fresh_) ++dropped_;  // overwriting an untaken frame = backlog drop
    for (uint32_t i = 0; i < n_; ++i) {
      stamps_[i] = stamps[i];
      handles_[i] = handles[i];
    }
    fresh_ = true;
  }

  int take(int64_t* stamps_out, uint64_t* handles_out) {
    std::lock_guard<std::mutex> lock(mu_);
    if (!fresh_) return 0;
    for (uint32_t i = 0; i < n_; ++i) {
      stamps_out[i] = stamps_[i];
      handles_out[i] = handles_[i];
    }
    fresh_ = false;
    return 1;
  }

  uint64_t dropped() {
    std::lock_guard<std::mutex> lock(mu_);
    return dropped_;
  }

 private:
  const uint32_t n_;
  std::mutex mu_;
  std::vector<int64_t> stamps_;
  std::vector<uint64_t> handles_;
  bool fresh_ = false;
  uint64_t dropped_ = 0;
};

}  // namespace

extern "C" {

void* ses3d_sync_create(uint32_t num_streams, uint32_t queue_size,
                        double age_penalty, int64_t max_interval_ns) {
  return new ApproxTimeSync(num_streams, queue_size, age_penalty,
                            max_interval_ns);
}

void ses3d_sync_destroy(void* s) { delete static_cast<ApproxTimeSync*>(s); }

void ses3d_sync_set_lower_bound(void* s, uint32_t stream, int64_t ns) {
  static_cast<ApproxTimeSync*>(s)->set_lower_bound(stream, ns);
}

uint32_t ses3d_sync_push(void* s, uint32_t stream, int64_t stamp_ns,
                         uint64_t handle) {
  return static_cast<ApproxTimeSync*>(s)->push(stream, stamp_ns, handle);
}

int ses3d_sync_pop(void* s, int64_t* stamps_out, uint64_t* handles_out) {
  return static_cast<ApproxTimeSync*>(s)->pop(stamps_out, handles_out);
}

uint32_t ses3d_sync_ready(void* s) {
  return static_cast<ApproxTimeSync*>(s)->ready_count();
}

void* ses3d_latest_create(uint32_t num_streams) {
  return new LatestSlot(num_streams);
}

void ses3d_latest_destroy(void* s) { delete static_cast<LatestSlot*>(s); }

void ses3d_latest_put(void* s, const int64_t* stamps,
                      const uint64_t* handles) {
  static_cast<LatestSlot*>(s)->put(stamps, handles);
}

int ses3d_latest_take(void* s, int64_t* stamps_out, uint64_t* handles_out) {
  return static_cast<LatestSlot*>(s)->take(stamps_out, handles_out);
}

uint64_t ses3d_latest_dropped(void* s) {
  return static_cast<LatestSlot*>(s)->dropped();
}

}  // extern "C"
