// Counts of CUDA runtime and driver API calls, for CUPTI's callback API.
//
// census_callback has the signature of CUPTI's CUpti_CallbackFunc; Python
// subscribes it (analysis/census/api_counter.py loads libcupti with ctypes and
// passes this function's address to cuptiSubscribe). CUPTI calls it at the
// entry and the exit of every API call of the enabled domains, in the thread
// that makes the call and before the call proceeds, so no call goes
// uncounted, the driver calls the runtime makes inside its own included. It
// counts the entries only, per (domain, callback id), and keeps the API
// function's name for each id it saw. No CUDA header is needed: the
// callback reads the first two fields of CUpti_CallbackData, its site (enter
// or exit) and the function's name.

#include <atomic>
#include <cstdint>

namespace {

constexpr int kDomains = 2;      // CUPTI_CB_DOMAIN_DRIVER_API = 1, CUPTI_CB_DOMAIN_RUNTIME_API = 2
constexpr uint32_t kIds = 8192;  // above every callback id of either domain
constexpr int kApiEnter = 0;     // CUPTI_API_ENTER

struct CallbackDataHead {  // the leading fields of CUpti_CallbackData
  int callback_site;
  const char* function_name;
};

std::atomic<long long> g_counts[kDomains][kIds];
std::atomic<const char*> g_names[kDomains][kIds];
std::atomic<long long> g_out_of_range{0};

}  // namespace

extern "C" {

void census_callback(void* /*userdata*/, int domain, uint32_t cbid, const void* cbdata) {
  if (domain < 1 || domain > kDomains || cbdata == nullptr) return;
  const auto* head = static_cast<const CallbackDataHead*>(cbdata);
  if (head->callback_site != kApiEnter) return;
  if (cbid >= kIds) {
    g_out_of_range.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  g_names[domain - 1][cbid].store(head->function_name, std::memory_order_relaxed);
  g_counts[domain - 1][cbid].fetch_add(1, std::memory_order_relaxed);
}

void census_reset() {
  for (int d = 0; d < kDomains; ++d)
    for (uint32_t i = 0; i < kIds; ++i) g_counts[d][i].store(0, std::memory_order_relaxed);
  g_out_of_range.store(0, std::memory_order_relaxed);
}

// The number of callback ids per domain the arrays hold.
uint32_t census_ids() { return kIds; }

// Copies every count into out[(domain - 1) * census_ids() + cbid].
void census_snapshot(long long* out) {
  for (int d = 0; d < kDomains; ++d)
    for (uint32_t i = 0; i < kIds; ++i) out[d * kIds + i] = g_counts[d][i].load(std::memory_order_relaxed);
}

const char* census_name(int domain, uint32_t cbid) {
  if (domain < 1 || domain > kDomains || cbid >= kIds) return nullptr;
  return g_names[domain - 1][cbid].load(std::memory_order_relaxed);
}

long long census_out_of_range() { return g_out_of_range.load(std::memory_order_relaxed); }

}  // extern "C"
