// import_port.cpp — points capi/flexflow_tpu_c.cpp's imports at the port.
//
// build.py compiles capi/flexflow_tpu_c.cpp unchanged and links it with
// -Wl,--wrap=PyImport_ImportModule, so every import it makes comes here:
// "flexflow_tpu" and "flexflow_tpu.<sub>" become "flexflow_tpu_torch" and
// "flexflow_tpu_torch.<sub>"; any other name is imported as given.
#include <Python.h>

#include <cstdio>
#include <cstring>

extern "C" {

PyObject* __real_PyImport_ImportModule(const char* name);

PyObject* __wrap_PyImport_ImportModule(const char* name) {
  static const char kJax[] = "flexflow_tpu";
  const size_t n = sizeof(kJax) - 1;
  if (std::strncmp(name, kJax, n) != 0 ||
      (name[n] != '\0' && name[n] != '.')) {
    return __real_PyImport_ImportModule(name);
  }
  char port[256];
  int len = std::snprintf(port, sizeof(port), "flexflow_tpu_torch%s",
                          name + n);
  if (len < 0 || static_cast<size_t>(len) >= sizeof(port)) {
    PyErr_Format(PyExc_ImportError, "module name too long: %s", name);
    return nullptr;
  }
  return __real_PyImport_ImportModule(port);
}

}  // extern "C"
